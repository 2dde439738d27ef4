"""Build/install volprim_tpu (mirrors reference setup.py:8-24, package
``volprim`` -> ``volprim_tpu``) including the native extension."""

from setuptools import Extension, find_packages, setup

setup(
    name="volprim_tpu",
    version="0.1.0",
    description=(
        "TPU-native differentiable volumetric-primitive renderer "
        "(JAX/XLA/Pallas rebuild of volprim)"
    ),
    packages=find_packages(
        include=[
            "volprim_tpu", "volprim_tpu.*",
            "volprim_tpu_torch", "volprim_tpu_torch.*",
        ]
    ),
    # the PyTorch port builds its CUDA kernels from these sources at first use
    package_data={"volprim_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "volprim_native",
            sources=["native/volprim_native.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        )
    ],
    install_requires=["jax", "numpy"],
    python_requires=">=3.10",
)
