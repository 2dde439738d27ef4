"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``build/kernels/<name>_<hash>.so`` under the repository root (a directory
``.gitignore`` lists), with a plain C interface, and loaded with
``ctypes``. The hash covers the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. A failed build raises with
nvcc's output. Nothing here runs at import time: the CPU tests import every
module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # the pair math keeps the plain version's rounding (see the .cu note)
    "-fmad=false",
    # registers, shared memory and spills per kernel, kept in build_info
    "-Xptxas", "-v",
)

_LIBS: dict = {}
build_info: dict = {}  # name -> {"path", "seconds", "log"} of this process's builds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
        build_info[name] = {
            "path": str(so), "seconds": seconds, "log": proc.stdout + proc.stderr,
        }
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
