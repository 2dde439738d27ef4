"""The plain reference of tomographic volume fitting.

Frozen copies of the port's absorption-only tomography integrator (a
masked sum over (ray, primitive) pairs in chunks of 1,024 primitives,
q's minimum from the closest point, each ray's sum in one fixed order,
each block of rays under ``torch.utils.checkpoint``), the batch sensor
(N cameras side by side, box splat), the grid's trilinear sample, the
absorption marcher that makes the targets, the L1 loss and BoundedAdam.
Plain PyTorch; imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .adam import BoundedAdam
from .scene import Scene, l1, pad_primitives, rotation_matrix

TOMO_PAIRS = 1 << 26  # (ray, primitive) pairs of one block (memory)
# the pair math's working precision: float32; a control sets a lower one
PAIR_DTYPE = torch.float32


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by halving folds: one fixed order."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 else y
    return x[..., 0]


def _chunk_tau(o, d, ctr, scl, qt, sig, is_real, extent: float):
    """Optical depth [R] and hit count [R] of rays o, d over one chunk of
    Gaussians (full range, unnormalized)."""
    rot = rotation_matrix(qt)
    inv_s = 1.0 / scl
    w, p = [], []
    for i in range(3):
        r0, r1, r2 = rot[:, 0, i][None, :], rot[:, 1, i][None, :], rot[:, 2, i][None, :]
        w.append((d[:, 0:1] * r0 + d[:, 1:2] * r1 + d[:, 2:3] * r2) * inv_s[None, :, i])
        p.append(((o[:, 0:1] - ctr[None, :, 0]) * r0 + (o[:, 1:2] - ctr[None, :, 1]) * r1
                  + (o[:, 2:3] - ctr[None, :, 2]) * r2) * inv_s[None, :, i])
    a = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    t_star = -(w[0] * p[0] + w[1] * p[1] + w[2] * p[2]) / a
    q_min = sum((p[i] + t_star * w[i]) ** 2 for i in range(3))
    e2 = extent * extent
    disc = (e2 - q_min) / a
    half = torch.sqrt(torch.clamp(disc, min=0.0))
    valid = (disc >= 0.0) & (t_star + half > 0.0) & (t_star - half > 0.0) & is_real[None, :]
    s_prod = (scl[:, 0] * scl[:, 1] * scl[:, 2])[None, :]
    dens = torch.exp(-0.5 * q_min) / (2.0 * math.pi * s_prod * torch.sqrt(a))
    dens = torch.clamp(dens, min=0.0)
    dens = torch.where(torch.isfinite(dens), dens, 0.0)
    dens = torch.where(valid, dens, 0.0)
    return _row_sum(dens * sig[None, :]), torch.sum(valid, dim=-1, dtype=torch.int32)


def tomo_radiance(prims: Scene, o, d, max_depth: int, chunk: int = 1024):
    """Radiance [R, 3] of rays o, d under a constant white emitter."""
    padded = pad_primitives(prims, chunk)
    n = padded.num_prims
    c = min(chunk, n)
    sigma_t = padded.attrs["sigma_t"].reshape(n)
    real = torch.arange(n, device=o.device) < prims.num_prims
    record = torch.is_grad_enabled()
    rb = max(1, TOMO_PAIRS // c)
    taus, counts = [], []
    for r0 in range(0, o.shape[0], rb):
        ob, db = o[r0:r0 + rb], d[r0:r0 + rb]
        tau = torch.zeros(ob.shape[0], dtype=o.dtype, device=o.device)
        count = torch.zeros(ob.shape[0], dtype=torch.int32, device=o.device)
        for c0 in range(0, n, c):
            part = slice(c0, c0 + c)
            dt = PAIR_DTYPE
            args = (ob.to(dt), db.to(dt), padded.centers[part].to(dt),
                    padded.scales[part].to(dt), padded.quats[part].to(dt),
                    sigma_t[part].to(dt), real[part], padded.extent)
            if record:
                dtau, dcount = checkpoint(_chunk_tau, *args, use_reentrant=False)
            else:
                dtau, dcount = _chunk_tau(*args)
            tau, count = tau + dtau.to(o.dtype), count + dcount
        taus.append(tau)
        counts.append(count)
    tau, count = torch.cat(taus), torch.cat(counts)
    beta = torch.exp(-tau)
    env = torch.ones(d.shape[:-1] + (3,), dtype=o.dtype, device=o.device)
    live = count <= max_depth if max_depth >= 0 else torch.ones_like(count, dtype=torch.bool)
    return torch.where(live[:, None], beta[:, None] * env, 0.0)


def batch_rays(cams, px, py):
    """Rays of N cameras through their film coordinates px, py [N, R]."""
    dev, f32 = px.device, torch.float32
    rot = torch.as_tensor(np.stack([c.to_world[:3, :3] for c in cams]), dtype=f32, device=dev)
    origin = torch.as_tensor(np.stack([c.to_world[:3, 3] for c in cams]), dtype=f32, device=dev)
    focal = torch.tensor([c.focal_length for c in cams], dtype=f32, device=dev)[:, None]
    ppx = torch.tensor([c.width / 2.0 for c in cams], dtype=f32, device=dev)[:, None]
    ppy = torch.tensor([c.height / 2.0 for c in cams], dtype=f32, device=dev)[:, None]
    dl = torch.stack([-(px - ppx) / focal, -(py - ppy) / focal, torch.ones_like(px)], dim=-1)
    d = torch.einsum("nij,nrj->nri", rot, dl)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = origin[:, None, :].expand(d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def render_batch(radiance, cams, spp: int, generator: torch.Generator, dev):
    """N same-size cameras side by side, [H, N W, 3]: per sample the jitter
    of all N films from ``generator``, one wavefront, a box splat."""
    h, w, n = cams[0].height, cams[0].width, len(cams)
    px0 = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w).reshape(-1)
    py0 = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
    shift = (torch.arange(n, dtype=torch.float32, device=dev) * w)[:, None]
    img = torch.zeros((h * n * w, 3), device=dev)
    wgt = torch.zeros((h * n * w,), device=dev)
    for _ in range(spp):
        off = torch.rand((n, h * w, 2), generator=generator, device=dev)
        px, py = px0 + off[..., 0], py0 + off[..., 1]
        o, d = batch_rays(cams, px, py)
        wide_px, wide_py = (px + shift).reshape(-1), py.reshape(-1)
        values = radiance(o, d)
        xi = torch.clamp(wide_px.to(torch.int64), 0, n * w - 1)
        yi = torch.clamp(wide_py.to(torch.int64), 0, h - 1)
        flat = yi * (n * w) + xi
        img = img + values.new_zeros((h * n * w, 3)).index_add_(0, flat, values)
        wgt = wgt + values.new_zeros((h * n * w,)).index_add_(0, flat, torch.ones_like(wide_px))
    return (img / torch.clamp(wgt[:, None], min=1e-8)).reshape(h, n * w, 3)


def generator(dev, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


# ---- the grid and its absorption marcher ------------------------------------------

def grid_sample(data, bbox_min, bbox_max, p):
    """Trilinear sample of ``data`` [z, y, x, C] at world points p [..., 3];
    zero outside the bbox; cell centres at the corners of the unit cube."""
    local = (p - bbox_min) / (bbox_max - bbox_min)
    inside = torch.all((local >= 0.0) & (local <= 1.0), dim=-1)
    nx, ny, nz = data.shape[2], data.shape[1], data.shape[0]
    f = [local[..., i] * (n - 1) for i, n in enumerate((nx, ny, nz))]
    lo = [torch.clamp(torch.floor(fi).to(torch.int64), 0, n - 1) for fi, n in zip(f, (nx, ny, nz))]
    ix, iy, iz = (torch.stack([li, torch.clamp(li + 1, max=n - 1)], dim=-1)
                  for li, n in zip(lo, (nx, ny, nz)))
    tx, ty, tz = ((fi - li.to(fi.dtype))[..., None] for fi, li in zip(f, lo))
    flat = (iz[..., :, None, None] * ny + iy[..., None, :, None]) * nx + ix[..., None, None, :]
    c = data.reshape(-1, data.shape[-1])[flat]
    c = c[..., 0, :] * (1 - tx[..., None, None, :]) + c[..., 1, :] * tx[..., None, None, :]
    c = c[..., 0, :] * (1 - ty[..., None, :]) + c[..., 1, :] * ty[..., None, :]
    out = c[..., 0, :] * (1 - tz) + c[..., 1, :] * tz
    return torch.where(inside[..., None], out, 0.0)


def absorption(data, bbox_min, bbox_max, sigma_scale: float, steps: int):
    """The absorption-only marcher as a radiance function of (o, d):
    exp(-sigma_scale x the midpoint sum of the grid) under a white emitter."""
    def radiance(o, d):
        inv_d = torch.where(torch.abs(d) > 1e-9, 1.0 / d, 1e9)
        t0, t1 = (bbox_min - o) * inv_d, (bbox_max - o) * inv_d
        t_near = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
        t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
        dt = (t_far - t_near) / steps
        tau = torch.zeros(o.shape[0], dtype=o.dtype, device=o.device)
        for i in range(steps):
            t = t_near + (i + 0.5) * dt
            tau = tau + grid_sample(data, bbox_min, bbox_max, o + d * t[:, None])[..., 0] * dt
        beta = torch.exp(-sigma_scale * torch.where(t_far > t_near, tau, 0.0))
        return beta[:, None] * torch.ones(d.shape[:-1] + (3,), dtype=o.dtype, device=o.device)
    return radiance


# ---- the training step ---------------------------------------------------------------

def to_scene(p: dict, extent: float) -> Scene:
    return Scene(p["centers"], p["scales"], p["quats"],
                 {"sigma_t": p["sigmat"], "albedo": p["albedo"]}, extent)


def train_step(params: dict, opt: BoundedAdam, cams, target, spp: int, seed: int,
               max_depth: int, extent: float) -> float:
    """One step in place: the batch sensor through the tomography
    integrator (its jitter from a generator seeded ``seed``), L1, backward,
    BoundedAdam. Returns the loss."""
    for p in params.values():
        p.grad = None
    scene = to_scene(params, extent)
    dev = params["centers"].device
    img = render_batch(lambda o, d: tomo_radiance(scene, o, d, max_depth), cams, spp,
                       generator(dev, seed), dev)
    loss = l1(target, img)
    loss.backward()
    opt.step(params)
    return float(loss.detach())
