"""The host PLY parser and Morton sort of ``native/volprim_native.cpp``,
built at first use (volprim_tpu.native).

The unchanged C++ source is compiled with ``g++`` into
``build/native/volprim_native_<hash><ext>`` under the repository root (a
directory ``.gitignore`` lists; the hash covers the source and the
interpreter) and imported from there. Both are host code, not device
kernels. Without a compiler, or for files it cannot read (ASCII PLYs), the
callers fall back to numpy.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent.parent / "native" / "volprim_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"

_mod = None
_tried = False


def _built_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + sys.version.encode()).hexdigest()[:12]
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"volprim_native_{tag}{ext}"


def get():
    """The native module, built if needed; None when it cannot be built."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    _tried = True
    if not SOURCE.exists():
        return None
    out = _built_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               f"-I{sysconfig.get_paths()['include']}", str(SOURCE), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
    spec = importlib.util.spec_from_file_location("volprim_native", out)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    _mod = module
    return _mod


def parse_ply_columns(path: str):
    """The vertex table of a binary PLY as {name: float32 column}, or None
    (no native module, or a file it does not parse, such as ASCII)."""
    mod = get()
    if mod is None:
        return None
    try:
        names, blob, n_props, n_verts = mod.parse_ply(str(path))
    except ValueError:
        return None
    mat = np.frombuffer(blob, dtype=np.float32).reshape(n_props, n_verts)
    return {name: mat[j] for j, name in enumerate(names)}


def morton_argsort(centers):
    """Stable argsort of the 30-bit Morton codes of positions [N, 3] (the
    native module's codes and radix sort) as int64 numpy, or None without
    the native module."""
    mod = get()
    if mod is None:
        return None
    if isinstance(centers, torch.Tensor):
        centers = centers.detach().cpu().numpy()
    c = np.ascontiguousarray(np.asarray(centers, np.float32))
    perm = mod.radix_argsort(mod.morton_codes(c.tobytes()))
    return np.frombuffer(perm, dtype=np.uint32).astype(np.int64)
