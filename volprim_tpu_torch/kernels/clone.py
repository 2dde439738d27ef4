"""The per-stage profiler's DMA-floor probe (tools/profile_rf.py ``clone``).

A kernel with the fused compositor's call shape that does no compositing:
per tile it reads the tile's d8 [8, R], pf [16, S] and sh3 [3k, S] blocks
and writes an [R, 8] block holding

    n_seg_t[t] + d8[t, 0, 0] + pf[t, 0, 0] + sh3[t, 0, 0] + ut[0, 0]

(f32, summed left to right). Its time is the floor that the grid and the
data movement of that call shape set, which the profiler sets beside the
compositor's (``volprim_tpu_torch.tools.profile_rf``, stage ``clone``).

- :func:`clone_reference` is the plain PyTorch version;
- :func:`clone` launches ``csrc/clone.cu`` for CUDA tensors (counted in
  ``clone.launches``) and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def clone_reference(n_seg_t, d8, pf, sh3, ut) -> torch.Tensor:
    """Plain version: [T, R, 8] f32, every element of tile t equal to
    0 + f32(n_seg_t[t]) + d8[t, 0, 0] + pf[t, 0, 0] + f32(sh3[t, 0, 0])
    + ut[0, 0], as the TPU kernel sums it."""
    t, _, r = d8.shape
    v = (n_seg_t.to(torch.float32) + d8[:, 0, 0] + pf[:, 0, 0]
         + sh3[:, 0, 0].to(torch.float32) + ut[0, 0])
    return torch.zeros((t, r, 8), dtype=torch.float32, device=d8.device) + v[:, None, None]


def _launch(n_seg_t, d8, pf, sh3, ut):
    """Launch csrc/clone.cu: [T, R, 8] f32."""
    t, rows, r = d8.shape
    s = pf.shape[-1]
    named = (("n_seg_t", n_seg_t, torch.int32), ("d8", d8, torch.float32),
             ("pf", pf, torch.float32), ("sh3", sh3, torch.bfloat16),
             ("ut", ut, torch.float32))
    for name, x, dtype in named:
        if x.device != d8.device:
            raise ValueError(f"{name} is on {x.device}, d8 on {d8.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if (rows != 8 or tuple(pf.shape) != (t, 16, s) or sh3.shape[0] != t
            or sh3.shape[2] != s or tuple(n_seg_t.shape) != (t,) or s % 8 or ut.numel() < 1):
        raise ValueError(
            f"clone takes n_seg_t [T], d8 [T, 8, R], pf [T, 16, S], sh3 [T, rows, S] "
            f"with S a multiple of 8; got {tuple(n_seg_t.shape)}, {tuple(d8.shape)}, "
            f"{tuple(pf.shape)}, {tuple(sh3.shape)}"
        )
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = _build.bind("clone", [vp] * 6 + [ci] * 4 + [vp], entry="clone_probe")
    out = torch.empty((t, r, 8), dtype=torch.float32, device=d8.device)
    with torch.cuda.device(d8.device):
        err = lib.clone_probe(
            n_seg_t.data_ptr(), d8.data_ptr(), pf.data_ptr(), sh3.data_ptr(),
            ut.data_ptr(), out.data_ptr(), t, r, s, sh3.shape[1],
            torch.cuda.current_stream(d8.device).cuda_stream,
        )
    _build.raise_on(lib, err, "clone")
    clone.launches += 1
    return out


def clone(n_seg_t, d8, pf, sh3, ut) -> torch.Tensor:
    """The probe: [T, R, 8] f32 (see the module docstring). CUDA tensors
    launch csrc/clone.cu and raise if it does not launch; CPU tensors take
    :func:`clone_reference`."""
    if d8.device.type == "cpu":
        return clone_reference(n_seg_t, d8, pf, sh3, ut)
    if d8.device.type != "cuda":
        raise ValueError(f"clone runs on CPU or CUDA, not {d8.device}")
    return _launch(n_seg_t, d8, pf, sh3, ut)


clone.launches = 0
