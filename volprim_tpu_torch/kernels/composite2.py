"""Camera-relative tile compositor v2, forward and backward
(volprim_tpu.pallas_kernels.composite2).

Every ray of a frame shares the camera origin o, so the quadric
coefficients of a (ray, column) pair collapse to::

    a = F6(d) . M6,   b = d . U,   c = c0           (per column)
    U = M (o - c),    c0 = (o - c)^T M (o - c)

with F6(d) = (dx^2, dy^2, dz^2, dx dy, dx dz, dy dz). The ray side is just
the direction: the kernels build F6 and the SH basis from d, and the
compositing is v1's (kernels/composite.py). The per-frame column table
comes from :func:`camera_relative_features_from_prims`.

- :func:`composite_tiles2_reference` / :func:`composite_tiles2_bwd_reference`
  are the plain PyTorch versions of the forward and of the backward (the TPU
  kernel's vector-Jacobian product, not autograd);
- :func:`composite_tiles2` is differentiable in pf_cam (rows 0-8), aux
  (opacity and c0) and sh3; d8 gets no gradient. CUDA tensors launch
  ``csrc/composite2_fwd.cu`` and ``csrc/composite2_bwd.cu`` (counted in
  ``composite_tiles2.launches`` and ``composite_tiles2_bwd.launches``); CPU
  tensors take the plain versions.

a and b are sums over 0..5 and 0..2, left to right, each operation rounded
once, in the kernels (built with ``-fmad=false``) and the plain versions.
"""

from __future__ import annotations

import torch

from ..ops import quaternion, sh
from . import _build
from . import composite as v1
from .composite import _FEAT, _SH, _log_kill


def camera_relative_features_from_prims(prims, origin: torch.Tensor) -> torch.Tensor:
    """[N, 16] camera-relative columns (M6, U = M (o - c), c0 = |p_loc|^2,
    pad) straight from the primitive parameters, in local coordinates
    (p_loc = diag(1/s) R^T (o - c)): well conditioned, unlike
    o^T M o - 2 o.Mc + c^T M c from the packed scene features.
    Differentiable in centers, scales and quats."""
    rot = quaternion.to_rotation_matrix(prims.quats)  # [N, 3, 3]
    inv_s = 1.0 / prims.scales
    rel = origin[None, :] - prims.centers

    def col_dot(v, i):  # (R^T v)_i = sum_j R_ji v_j
        return rot[:, 0, i] * v[:, 0] + rot[:, 1, i] * v[:, 1] + rot[:, 2, i] * v[:, 2]

    p_loc = torch.stack([col_dot(rel, i) for i in range(3)], dim=-1) * inv_s
    c0 = p_loc[:, 0] * p_loc[:, 0] + p_loc[:, 1] * p_loc[:, 1] + p_loc[:, 2] * p_loc[:, 2]
    ps = p_loc * inv_s
    u = [rot[:, i, 0] * ps[:, 0] + rot[:, i, 1] * ps[:, 1] + rot[:, i, 2] * ps[:, 2]
         for i in range(3)]
    is2 = inv_s * inv_s

    def m(i, j):
        return (rot[:, i, 0] * is2[:, 0] * rot[:, j, 0] + rot[:, i, 1] * is2[:, 1] * rot[:, j, 1]
                + rot[:, i, 2] * is2[:, 2] * rot[:, j, 2])

    zero = torch.zeros_like(c0)
    return torch.stack(
        [m(0, 0), m(1, 1), m(2, 2), 2.0 * m(0, 1), 2.0 * m(0, 2), 2.0 * m(1, 2),
         *u, c0] + [zero] * 6,
        dim=-1,
    )


def camera_relative_features(feats16: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """[N, 16] scene features (M6, Mc, cMc) and the camera origin o ->
    [N, 16] camera-relative features (M6, U = Mo - Mc, c0 = o^T M o -
    2 o.Mc + cMc, zeros). Differentiable in both; c0 cancels where the
    primitives are small against |o - c|, which
    :func:`camera_relative_features_from_prims` avoids."""
    m11, m22, m33 = feats16[:, 0], feats16[:, 1], feats16[:, 2]
    m12, m13, m23 = 0.5 * feats16[:, 3], 0.5 * feats16[:, 4], 0.5 * feats16[:, 5]
    mc = feats16[:, 6:9]
    cmc = feats16[:, 9]
    ox, oy, oz = origin[0], origin[1], origin[2]
    mo = torch.stack(
        [m11 * ox + m12 * oy + m13 * oz, m12 * ox + m22 * oy + m23 * oz,
         m13 * ox + m23 * oy + m33 * oz],
        dim=-1,
    )
    u = mo - mc
    c0 = (mo[:, 0] * ox + mo[:, 1] * oy + mo[:, 2] * oz
          - 2.0 * (mc[:, 0] * ox + mc[:, 1] * oy + mc[:, 2] * oz) + cmc)
    return torch.cat([feats16[:, 0:6], u, c0[:, None], torch.zeros_like(feats16[:, 10:])],
                     dim=1)


def neutral_row(origin: torch.Tensor) -> torch.Tensor:
    """The inert camera-relative column (M = I, c = 0): a = |d|^2 > 0,
    U = o; its c0 |o|^2 goes into aux, and its opacity is 0."""
    row = torch.zeros((_FEAT,), dtype=origin.dtype, device=origin.device)
    row[:3] = 1.0
    row[6:9] = origin
    return row


def _ray_terms(d8):
    """(dx, dy, dz) [T, R, 1] and F6(d), in d8's dtype."""
    dx, dy, dz = (d8[:, :, i:i + 1] for i in range(3))
    return (dx, dy, dz), (dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz)


def _basis(d8, sh_k):
    """The SH basis [T, R, 16] of the directions (zero beyond sh_k)."""
    dx, dy, dz = (d8[:, :, i:i + 1] for i in range(3))
    cols = sh.basis_columns(dx, dy, dz, sh.degree_from_coeffs(sh_k), sh._C0)
    return torch.cat(cols + [torch.zeros_like(dx)] * (_SH - sh_k), dim=-1)


def _walk_args(d8, pf_cam, aux, sh3, seg, sh_k, pair_dtype=None):
    """(coeffs_of, opac_of, emission_of, d3, f6, basis) of the v2 plain
    versions, in pf_cam's dtype; a, b, c (and F6, d3) in ``pair_dtype``."""
    dtype = pf_cam.dtype
    pair = pair_dtype or dtype
    d3, f6 = _ray_terms(d8.to(pair))
    basis = _basis(d8.to(dtype), sh_k)
    pf_pair, c0, aux = pf_cam.to(pair), aux[:, 1:2].to(pair), aux.to(dtype)

    def coeffs_of(si):
        cols = pf_pair[:, None, si * seg:(si + 1) * seg, :]  # [T, 1, C, 16]
        a = f6[0] * cols[..., 0]
        for i in range(1, 6):
            a = a + f6[i] * cols[..., i]
        b = d3[0] * cols[..., 6]
        for i in range(1, 3):
            b = b + d3[i] * cols[..., 6 + i]
        c = c0[:, :, si * seg:(si + 1) * seg]  # [T, 1, C]
        return a, b, c

    def opac_of(si):
        return aux[:, 0:1, si * seg:(si + 1) * seg]

    return coeffs_of, opac_of, v1.emission_fn(basis, sh3, seg), d3, f6, basis


def composite_tiles2_reference(d8, pf_cam, aux, sh3, seg=256, extent2=9.0,
                               max_depth=128, beta_kill=0.01, sh_k=16):
    """Plain PyTorch version of the v2 forward compositor. d8 [T, R, 8]
    (direction in 0-2); pf_cam [T, S, 16]; aux [T, 2, S] (opacity, c0);
    sh3 [T, S, 48]. Returns (L [T, R, 3], beta [T, R]) in pf_cam's dtype."""
    t, r, _ = d8.shape
    n_seg = v1._check_seg(pf_cam.shape[1], seg)
    coeffs_of, opac_of, emission_of, *_ = _walk_args(d8, pf_cam, aux, sh3, seg, sh_k)
    return v1.walk_reference(coeffs_of, opac_of, emission_of, t, r, n_seg, pf_cam.dtype,
                             pf_cam.device, extent2, max_depth, beta_kill)


def composite_tiles2_bwd_reference(d8, pf_cam, aux, sh3, g_l, g_beta, seg=256,
                                   extent2=9.0, max_depth=128, beta_kill=0.01,
                                   sh_k=16, pair_dtype=None):
    """Plain PyTorch version of the v2 backward: (gpf [T, S, 16] with rows
    0-8 live, gaux [T, 2, S], gsh [T, S, 48]) in pf_cam's dtype (f64 inputs
    give the yardstick; ``pair_dtype`` as in
    ``composite_vjp.composite_tiles_bwd_reference``)."""
    t, r, _ = d8.shape
    s = pf_cam.shape[1]
    n_seg = v1._check_seg(s, seg)
    dtype, dev = pf_cam.dtype, pf_cam.device
    coeffs_of, opac_of, emission_of, d3, f6, basis = _walk_args(
        d8, pf_cam, aux, sh3, seg, sh_k, pair_dtype
    )
    f6t = torch.cat(f6, dim=-1).to(dtype)  # [T, R, 6]
    d3t = torch.cat(d3, dim=-1).to(dtype)
    gpf = torch.zeros((t, s, _FEAT), dtype=dtype, device=dev)
    gaux = torch.zeros((t, 2, s), dtype=dtype, device=dev)
    gsh = torch.zeros((t, s, 3 * _SH), dtype=dtype, device=dev)

    def accumulate(si, g_a, g_b, g_q, g_opac, g_e):
        sl = slice(si * seg, (si + 1) * seg)
        gpf[:, sl, 0:6] = torch.matmul(g_a.transpose(1, 2), f6t)
        gpf[:, sl, 6:9] = torch.matmul(g_b.transpose(1, 2), d3t)
        gaux[:, 0, sl] = torch.sum(g_opac, dim=1)
        gaux[:, 1, sl] = torch.sum(g_q, dim=1)  # c0 enters as c
        for ch in range(3):
            gsh[:, sl, ch * _SH:(ch + 1) * _SH] = torch.matmul(g_e[ch].transpose(1, 2), basis)

    v1.walk_bwd_reference(coeffs_of, opac_of, emission_of, g_l, g_beta, t, r, n_seg,
                          dtype, dev, extent2, max_depth, beta_kill, accumulate)
    return gpf, gaux, gsh


# composite2_bwd's C signature: 11 tensor pointers; T, R, S, seg, k
_BWD_ARGTYPES = v1.argtypes(11, 5)


def _inputs(d8, pf_cam, aux, sh3, seg, sh_k):
    """Checks of the v2 kernels' inputs; returns (T, R, S)."""
    t, r, _ = d8.shape
    s = pf_cam.shape[1]
    v1.check_sizes(r, s, seg)
    if sh_k not in (1, 4, 9, 16):
        raise ValueError(f"sh_k must be 1, 4, 9 or 16, got {sh_k}")
    f32 = torch.float32
    v1.check_tensors(
        [("d8", d8, f32, (t, r, 8)), ("pf_cam", pf_cam, f32, (t, s, _FEAT)),
         ("aux", aux, f32, (t, 2, s)), ("sh3", sh3, f32, (t, s, 3 * _SH))],
        d8.device,
    )
    return t, r, s


def _launch(d8, pf_cam, aux, sh3, seg, extent2, max_depth, beta_kill, sh_k):
    """Launch csrc/composite2_fwd.cu: (L [T, R, 3], beta [T, R])."""
    t, r, s = _inputs(d8, pf_cam, aux, sh3, seg, sh_k)
    dev = d8.device
    lib = v1.load_lib("composite2_fwd", 6, 5)
    l_out = torch.empty((t, r, 3), dtype=torch.float32, device=dev)
    beta = torch.empty((t, r), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.composite2_fwd(
            d8.data_ptr(), pf_cam.data_ptr(), aux.data_ptr(), sh3.data_ptr(),
            l_out.data_ptr(), beta.data_ptr(), t, r, s, seg, sh_k, float(extent2),
            int(max_depth), _log_kill(beta_kill), v1.stream_of(dev),
        )
    _build.raise_on(lib, err, "composite2_fwd")
    composite_tiles2.launches += 1
    return l_out, beta


def _launch_bwd(d8, pf_cam, aux, sh3, g_l, g_beta, seg, extent2, max_depth,
                beta_kill, sh_k):
    """Launch csrc/composite2_bwd.cu: (gpf, gaux, gsh), all f32."""
    t, r, s = _inputs(d8, pf_cam, aux, sh3, seg, sh_k)
    f32 = torch.float32
    dev = d8.device
    v1.check_tensors([("g_l", g_l, f32, (t, r, 3)), ("g_beta", g_beta, f32, (t, r))], dev)
    lib = _build.bind("composite2_bwd", _BWD_ARGTYPES)
    gpf = torch.empty((t, s, _FEAT), dtype=f32, device=dev)
    gaux = torch.empty((t, 2, s), dtype=f32, device=dev)
    gsh = torch.empty((t, s, 3 * _SH), dtype=f32, device=dev)
    lb_scr = torch.empty((t, s // seg, r), dtype=f32, device=dev)
    cnt_scr = torch.empty((t, s // seg, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.composite2_bwd(
            d8.data_ptr(), pf_cam.data_ptr(), aux.data_ptr(), sh3.data_ptr(),
            g_l.data_ptr(), g_beta.data_ptr(), lb_scr.data_ptr(), cnt_scr.data_ptr(),
            gpf.data_ptr(), gaux.data_ptr(), gsh.data_ptr(), t, r, s, seg, sh_k,
            float(extent2), int(max_depth), _log_kill(beta_kill), v1.stream_of(dev),
        )
    _build.raise_on(lib, err, "composite2_bwd")
    composite_tiles2_bwd.launches += 1
    return gpf, gaux, gsh


def composite_tiles2_fwd(d8, pf_cam, aux, sh3, seg=256, extent2=9.0, max_depth=128,
                         beta_kill=0.01, sh_k=16):
    """v2 forward compositor, not differentiable: CUDA tensors launch
    csrc/composite2_fwd.cu and raise if it does not launch; CPU tensors take
    :func:`composite_tiles2_reference`."""
    args = (seg, extent2, max_depth, beta_kill, sh_k)
    if d8.device.type == "cpu":
        return composite_tiles2_reference(d8, pf_cam, aux, sh3, *args)
    if d8.device.type != "cuda":
        raise ValueError(f"composite_tiles2 runs on CPU or CUDA, not {d8.device}")
    return _launch(d8, pf_cam, aux, sh3, *args)


def composite_tiles2_bwd(d8, pf_cam, aux, sh3, g_l, g_beta, seg=256, extent2=9.0,
                         max_depth=128, beta_kill=0.01, sh_k=16):
    """v2 backward compositor: (gpf [T, S, 16], gaux [T, 2, S],
    gsh [T, S, 48]). CUDA tensors launch csrc/composite2_bwd.cu and raise if
    it does not launch; CPU tensors take
    :func:`composite_tiles2_bwd_reference`."""
    args = (seg, extent2, max_depth, beta_kill, sh_k)
    if d8.device.type == "cpu":
        return composite_tiles2_bwd_reference(d8, pf_cam, aux, sh3, g_l, g_beta, *args)
    if d8.device.type != "cuda":
        raise ValueError(f"composite_tiles2_bwd runs on CPU or CUDA, not {d8.device}")
    return _launch_bwd(d8, pf_cam, aux, sh3, g_l.contiguous(), g_beta.contiguous(), *args)


composite_tiles2_bwd.launches = 0


class _Composite2(torch.autograd.Function):
    """The v2 compositor with the backward of composite2._bwd_rule; an
    unused beta output is a zero cotangent."""

    @staticmethod
    def forward(ctx, d8, pf_cam, aux, sh3, seg, extent2, max_depth, beta_kill, sh_k):
        args = (seg, extent2, max_depth, beta_kill, sh_k)
        out = composite_tiles2_fwd(d8, pf_cam, aux, sh3, *args)
        ctx.save_for_backward(d8, pf_cam, aux, sh3)
        ctx.args = args
        ctx.set_materialize_grads(True)
        return out

    @staticmethod
    def backward(ctx, g_l, g_beta):
        grads = composite_tiles2_bwd(*ctx.saved_tensors, g_l, g_beta, *ctx.args)
        need = ctx.needs_input_grad[1:4]
        return (None,) + tuple(g if n else None for g, n in zip(grads, need)) + (None,) * 5


def composite_tiles2(d8, pf_cam, aux, sh3, seg=256, extent2=9.0, max_depth=128,
                     beta_kill=0.01, sh_k=16):
    """Differentiable v2 compositor: (L [T, R, 3], beta [T, R]), with
    gradients for pf_cam (rows 0-8), aux and sh3."""
    return _Composite2.apply(d8, pf_cam, aux, sh3, seg, extent2, max_depth, beta_kill,
                             sh_k)


composite_tiles2.launches = 0
