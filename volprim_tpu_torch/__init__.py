"""PyTorch + CUDA port of the volprim_tpu renderer.

The JAX package ``volprim_tpu`` stays the reference; this package keeps its
module paths and public names (``ops``, ``scene``, ``accel``, ``models``,
``kernels``) so each function has an obvious counterpart. It imports torch
and numpy only. Every Pallas kernel on a ported path becomes a hand-written
CUDA kernel under ``csrc/``, built at first use (``kernels/_build.py``),
with a plain PyTorch version beside it that CPU tensors take.

Float32 matmuls and convolutions are pinned to full f32 precision: the
quadric coefficient math cancels catastrophically in TF32 (the JAX package
measured 17 dB vs 78 dB images from reduced-precision coefficient GEMMs).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The first CUDA device. Without a card this raises: the port runs on
    the CPU only when the caller asks for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def as_device(device=None) -> torch.device:
    """Normalise a device argument; ``None`` means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


from . import accel, kernels, models, ops, optim, parallel, scene, utils  # noqa: E402

# the JAX package's aliases (the reference's volprim.cameras, .io, .optimizers,
# .benchmark)
cameras = scene.cameras
io = scene.asset
optimizers = optim
benchmark = utils.benchmark

__version__ = "0.1.0"
