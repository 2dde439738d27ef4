"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``build/kernels/<name>_<hash>.so`` under the repository root (a directory
``.gitignore`` lists), with a plain C interface, and loaded with
``ctypes``. The hash covers the source, every ``csrc`` header it includes
(``#include "x.cuh"``, followed recursively) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. nvcc's
output (ptxas's registers and spills per kernel) is kept beside the library
as ``<name>_<hash>.log``.
:func:`build` starts one nvcc per source, all at once. A failed build
raises with nvcc's output. Nothing here runs at import time: the CPU tests
import every module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the csrc headers it includes, recursively."""
    todo, seen = [CSRC_DIR / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC_DIR / h for h in _INCLUDE.findall(path.read_text())]
    return seen


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build the libraries of ``names`` that are not built yet, one nvcc
    process per source, all started together."""
    todo = [(n, library_path(n)) for n in names if n not in _LIBS]
    todo = [(n, so) for n, so in todo if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, so in todo:
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, so, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, cmd, proc, t0 in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}"
            )
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
        build_info[name] = {"path": str(so), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def build_log(name: str) -> str:
    """nvcc's output for the current library of ``csrc/<name>.cu`` (this
    process's build, or the one kept beside the library); "" if none."""
    if name in build_info:
        return build_info[name]["log"]
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


_BOUND: set = set()


def bind(name: str, argtypes: list, entry: str = None) -> ctypes.CDLL:
    """:func:`load`, with the entry point ``entry`` (default ``name``)
    taking ``argtypes`` and returning an int error code, and
    ``<entry>_error_string`` bound as ``lib.error_string``."""
    lib = load(name)
    entry = entry or name
    if name not in _BOUND:
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        err = getattr(lib, f"{entry}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        lib.error_string = err
        _BOUND.add(name)
    return lib


def raise_on(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if the entry point ``name`` returned a nonzero error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.error_string(err).decode()} ({err})")
