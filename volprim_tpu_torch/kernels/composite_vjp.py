"""Tile compositor v1, backward (volprim_tpu.pallas_kernels.composite_vjp).

- :func:`composite_tiles_bwd_reference` is the plain PyTorch version of
  the backward: the TPU kernel's vector-Jacobian product (a forward sweep
  keeps each segment's (log beta, hit count) carry, a reverse sweep
  recomputes each segment and accumulates the adjoints), not autograd;
- :func:`composite_tiles_bwd` launches ``csrc/composite_bwd.cu`` for CUDA
  tensors (counted in ``composite_tiles_bwd.launches``) and takes the plain
  version for CPU tensors; the kernel carries only the basis columns up to
  the last that is nonzero somewhere (:func:`live_sh_k`);
- :func:`composite_tiles_ad` is the differentiable compositor: gradients
  reach pf, opac and sh3. The ray features and the basis get none (JAX
  returns zeros for them: camera rays are not trained).

Per pair the adjoints are those of ``q = c - b^2 / a``: g_a = g_q b^2 / a^2,
g_b = -2 g_q b / a, g_c = g_q, and
``gpf[c, f] = sum_r fa[r, f] g_a + fb[r, f] g_b + fc[r, f] g_c`` over the
live features f < 10 (columns 10-15 of gpf are 0).
"""

from __future__ import annotations

import torch

from . import _build
from . import composite as fwd
from .composite import _FEAT, _LIVE, _SH


def composite_tiles_bwd_reference(fa, fb, fc, basis, pf, opac, sh3, g_l, g_beta,
                                  seg=256, extent2=9.0, max_depth=128,
                                  beta_kill=0.01, pair_dtype=None):
    """Plain PyTorch version of the v1 backward. g_l [T, R, 3] and
    g_beta [T, R] are the cotangents of L and beta. Returns (gpf [T, S, 16],
    gopac [T, 1, S], gsh [T, S, 48]) in pf's dtype: f32 as the kernel
    computes; given f64 inputs it is the yardstick the tests and
    chip_smoke.py hold both f32 versions to. ``pair_dtype`` (default pf's)
    is the dtype in which a, b, c, q and the hit test are formed: f64
    inputs with ``pair_dtype=torch.float32`` take the f32 versions' q and
    hits, whose cancellation in c - b^2 / a is part of the function, and
    compute everything after them in f64."""
    t, r, _ = fa.shape
    s = pf.shape[1]
    n_seg = fwd._check_seg(s, seg)
    dtype, dev = pf.dtype, pf.device
    coeffs_of = fwd.v1_coeffs(*(x.to(pair_dtype or dtype) for x in (fa, fb, fc, pf)), seg)
    fa, fb, fc, basis = (x.to(dtype) for x in (fa, fb, fc, basis))
    opac = opac.to(dtype)
    gpf = torch.zeros((t, s, _FEAT), dtype=dtype, device=dev)
    gopac = torch.zeros((t, 1, s), dtype=dtype, device=dev)
    gsh = torch.zeros((t, s, 3 * _SH), dtype=dtype, device=dev)
    ft = [f[..., :_LIVE] for f in (fa, fb, fc)]

    def accumulate(si, g_a, g_b, g_q, g_opac, g_e):
        sl = slice(si * seg, (si + 1) * seg)
        # [T, C, R] x [T, R, 10] -> [T, C, 10]
        gpf[:, sl, :_LIVE] = sum(
            torch.matmul(g.transpose(1, 2), f) for g, f in zip((g_a, g_b, g_q), ft)
        )
        gopac[:, 0, sl] = torch.sum(g_opac, dim=1)
        for ch in range(3):
            gsh[:, sl, ch * _SH:(ch + 1) * _SH] = torch.matmul(g_e[ch].transpose(1, 2), basis)

    fwd.walk_bwd_reference(
        coeffs_of,
        lambda si: opac[:, :, si * seg:(si + 1) * seg],
        fwd.emission_fn(basis, sh3, seg),
        g_l, g_beta, t, r, n_seg, dtype, dev, extent2, max_depth, beta_kill, accumulate,
    )
    return gpf, gopac, gsh


# composite_bwd's C signature: 14 tensor pointers; T, R, S, seg, k
_BWD_ARGTYPES = fwd.argtypes(14, 5)


def live_sh_k(basis) -> int:
    """The SH count the v1 backward kernel is instantiated for: the least
    of 1, 4, 9, 16 that covers every column of ``basis`` [T, R, 16] that is
    nonzero somewhere (rf_tiled pads the basis with zero columns past its
    k). One device-to-host read."""
    nz = (basis != 0).reshape(-1, basis.shape[-1]).any(dim=0)
    last = int((nz * torch.arange(1, nz.numel() + 1, device=basis.device)).max())
    return next(k for k in (1, 4, 9, 16) if k >= last)


def _launch_bwd(fa, fb, fc, basis, pf, opac, sh3, g_l, g_beta, seg, extent2,
                max_depth, beta_kill):
    """Launch csrc/composite_bwd.cu: (gpf, gopac, gsh), all f32."""
    t, r, s = fwd.v1_inputs(fa, fb, fc, basis, pf, opac, sh3, seg)
    f32 = torch.float32
    dev = fa.device
    fwd.check_tensors([("g_l", g_l, f32, (t, r, 3)), ("g_beta", g_beta, f32, (t, r))], dev)
    lib = _build.bind("composite_bwd", _BWD_ARGTYPES)
    gpf = torch.empty((t, s, _FEAT), dtype=f32, device=dev)
    gopac = torch.empty((t, 1, s), dtype=f32, device=dev)
    gsh = torch.empty((t, s, 3 * _SH), dtype=f32, device=dev)
    # per-segment (log beta, hit count) carries of every ray
    lb_scr = torch.empty((t, s // seg, r), dtype=f32, device=dev)
    cnt_scr = torch.empty((t, s // seg, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.composite_bwd(
            fa.data_ptr(), fb.data_ptr(), fc.data_ptr(), basis.data_ptr(),
            pf.data_ptr(), opac.data_ptr(), sh3.data_ptr(), g_l.data_ptr(),
            g_beta.data_ptr(), lb_scr.data_ptr(), cnt_scr.data_ptr(),
            gpf.data_ptr(), gopac.data_ptr(), gsh.data_ptr(),
            t, r, s, seg, live_sh_k(basis), float(extent2), int(max_depth),
            fwd._log_kill(beta_kill), fwd.stream_of(dev),
        )
    _build.raise_on(lib, err, "composite_bwd")
    composite_tiles_bwd.launches += 1
    return gpf, gopac, gsh


def composite_tiles_bwd(fa, fb, fc, basis, pf, opac, sh3, g_l, g_beta, seg=256,
                        extent2=9.0, max_depth=128, beta_kill=0.01):
    """v1 backward compositor: (gpf [T, S, 16], gopac [T, 1, S],
    gsh [T, S, 48]). CUDA tensors launch the hand-written kernel
    (csrc/composite_bwd.cu) and raise if it does not launch; CPU tensors
    take :func:`composite_tiles_bwd_reference`."""
    args = (seg, extent2, max_depth, beta_kill)
    if fa.device.type == "cpu":
        return composite_tiles_bwd_reference(fa, fb, fc, basis, pf, opac, sh3, g_l,
                                             g_beta, *args)
    if fa.device.type != "cuda":
        raise ValueError(f"composite_tiles_bwd runs on CPU or CUDA, not {fa.device}")
    return _launch_bwd(fa, fb, fc, basis, pf, opac, sh3, g_l.contiguous(),
                       g_beta.contiguous(), *args)


composite_tiles_bwd.launches = 0


class _CompositeAD(torch.autograd.Function):
    """The v1 compositor with the backward of composite_vjp._bwd_rule. An
    unused beta output is a zero cotangent."""

    @staticmethod
    def forward(ctx, fa, fb, fc, basis, pf, opac, sh3, seg, extent2, max_depth,
                beta_kill):
        args = (seg, extent2, max_depth, beta_kill)
        out = fwd.composite_tiles(fa, fb, fc, basis, pf, opac, sh3, *args)
        ctx.save_for_backward(fa, fb, fc, basis, pf, opac, sh3)
        ctx.args = args
        ctx.set_materialize_grads(True)
        return out

    @staticmethod
    def backward(ctx, g_l, g_beta):
        grads = composite_tiles_bwd(*ctx.saved_tensors, g_l, g_beta, *ctx.args)
        need = ctx.needs_input_grad[4:7]
        return (None,) * 4 + tuple(g if n else None for g, n in zip(grads, need)) + (None,) * 4


def composite_tiles_ad(fa, fb, fc, basis, pf, opac, sh3, seg=256, extent2=9.0,
                       max_depth=128, beta_kill=0.01):
    """Differentiable v1 compositor: (L [T, R, 3], beta [T, R]), with
    gradients for pf, opac and sh3. CUDA tensors launch csrc/composite_fwd.cu
    and, in the backward, csrc/composite_bwd.cu; CPU tensors take the plain
    versions."""
    return _CompositeAD.apply(fa, fb, fc, basis, pf, opac, sh3, seg, extent2,
                              max_depth, beta_kill)
