"""Inputs of every cell, made from ``--seed`` by the benchmark's own code.

Frozen copies of the port's scene generators, drawn anew with torch on the
device where the sizes are large: the trained-3DGS-like surface scene of
``scene/synthetic.make_scene`` (the same distribution, a torch generator's
draws), refine_truck's "strong" perturbation, the ring and orbit cameras,
``procedural_smoke``'s grid and ``lattice_init``'s lattice. A change to the
port therefore cannot change what the port is given, and the reference
takes nothing that the port has made. Cameras are plain dicts (width,
height, to_world, fov) that each side turns into its own camera type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F64 = torch.float64


def look_at(origin, target, up) -> np.ndarray:
    """Mitsuba-convention to_world (x left, y up, z forward)."""
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(target, np.float64) - origin
    direction = direction / np.linalg.norm(direction)
    left = np.cross(np.asarray(up, np.float64), direction)
    left = left / np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(direction, left), direction, origin
    return m


def _rotate(axis: str, deg: float) -> np.ndarray:
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m = np.eye(4)
    if axis == "x":
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    else:
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def ring_cameras(count: int, width: int, height: int, radius: float, elev: float,
                 fov: float, offset: float = 0.0) -> list:
    """``count`` cameras on a ring about the y axis at ``radius`` and height
    ``elev``, looking at the origin (refine_truck's training ring)."""
    cams = []
    for i in range(count):
        ang = 2.0 * np.pi * (i + offset) / count
        pos = [radius * np.sin(ang), elev, -radius * np.cos(ang)]
        cams.append(dict(width=width, height=height, fov=fov,
                         to_world=look_at(pos, [0, 0, 0], [0, 1, 0])))
    return cams


def tomo_cameras(count: int, res: int, seed: int) -> list:
    """optimize_volume's ring: ``count`` cameras on a half ring at distance
    4, each raised by an elevation drawn in [-45, 45) degrees, fov 40."""
    rng = np.random.RandomState(seed % 2 ** 32)
    cams = []
    for i in range(count):
        to_world = (_rotate("y", 180.0 / count * i - 90.0) @ _rotate("x", 90.0 * rng.rand() - 45.0)
                    @ look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]))
        cams.append(dict(width=res, height=res, fov=40.0, to_world=to_world))
    return cams


def _gen(seed: int, dev) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed % 2 ** 63)
    return g


def splat_scene(n: int, seed: int, dev) -> dict:
    """The surface scene of ``n`` splats as f32 tensors on ``dev``: thin
    tangent splats on three bumpy spheres and a ground sheet on y = -1,
    opacities in [0.55, 0.99], degree-1 SH (the distribution of the port's
    ``synthetic.make_scene_arrays``, drawn by a torch generator)."""
    g = _gen(seed, dev)

    def uni(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev, dtype=_F64)

    def nrm(shape):
        return torch.randn(shape, generator=g, device=dev, dtype=_F64)

    n_ground = n // 4
    n_obj = n - n_ground
    g_centers = torch.stack([uni(n_ground, -3, 3), -1.0 + nrm(n_ground) * 0.005,
                             uni(n_ground, -3, 3)], dim=-1)
    g_normals = torch.tensor([0.0, 1.0, 0.0], dtype=_F64, device=dev) + nrm((n_ground, 3)) * 0.05
    objs = (([-1.1, -0.25, 0.3], 0.75), ([1.0, -0.1, -0.2], 0.9), ([0.0, 0.35, 1.0], 0.65))
    per = n_obj // len(objs)
    centers, normals = [g_centers], [g_normals]
    for c, r0 in objs:
        dirs = nrm((per, 3))
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        bump = (1.0 + 0.18 * torch.sin(4.1 * dirs[:, 0] + 1.2) * torch.cos(3.3 * dirs[:, 1])
                + 0.12 * torch.sin(5.7 * dirs[:, 2]))
        centers.append(torch.tensor(c, dtype=_F64, device=dev) + dirs * (r0 * bump[:, None]))
        normals.append(dirs)
    rem = n_obj - per * len(objs)
    if rem:
        centers.append(centers[1][:rem])
        normals.append(normals[1][:rem])
    centers, normals = torch.cat(centers), torch.cat(normals)
    # quaternions turning local +z onto each normal, spun about it at random
    nn = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-9)
    axis = torch.stack([-nn[:, 1], nn[:, 0], torch.zeros_like(nn[:, 0])], dim=-1)  # z x n
    w = 1.0 + nn[:, 2:3]
    q = torch.cat([axis, w], dim=1)
    q = torch.where((w[:, 0] < 1e-6)[:, None], torch.tensor([1.0, 0, 0, 0], dtype=_F64,
                                                          device=dev), q)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    ang = uni((n, 1), 0.0, math.pi)
    spin = torch.cat([torch.sin(ang) * nn, torch.cos(ang)], dim=1)
    x1, y1, z1, w1 = spin.T
    x2, y2, z2, w2 = q.T
    quats = torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                         w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                         w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                         w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=1)
    # about 4 splats over any surface point: density * pi (2 sigma)^2 ~ 4
    sig = torch.empty((n,), dtype=_F64, device=dev)
    sig[:n_ground] = math.sqrt(4.0 / (n_ground / 36.0) / math.pi) / 2.0
    sig[n_ground:] = math.sqrt(4.0 / (n_obj / 30.0) / math.pi) / 2.0
    tangent = sig[:, None] * torch.exp(0.3 * nrm((n, 2)))
    normal_s = tangent[:, :1] * uni((n, 1), 0.08, 0.25)
    f32 = torch.float32
    return dict(
        centers=centers.to(f32), scales=torch.cat([tangent, normal_s], dim=1).to(f32),
        quats=quats.to(f32), opacities=uni((n, 1), 0.55, 0.99).to(f32),
        sh_coeffs=torch.cat([nrm((n, 3)) * 0.3, nrm((n, 9)) * 0.1], dim=1).to(f32))


def perturb_strong(op: torch.Tensor, sh: torch.Tensor, seed: int) -> tuple:
    """refine_truck's "strong" initial asset: opacities scaled by U(0.05,
    0.5) and clipped to [1e-4, 0.995], SH scaled by U(0, 0.6) plus N(0,
    0.6) noise; geometry kept."""
    g = _gen(seed * 7 + 1, op.device)
    op_p = torch.clamp(op * (0.05 + 0.45 * torch.rand(op.shape, generator=g, device=op.device)),
                       1e-4, 0.995)
    sh_p = (sh * (0.6 * torch.rand(sh.shape, generator=g, device=sh.device))
            + 0.6 * torch.randn(sh.shape, generator=g, device=sh.device))
    return op_p, sh_p


def smoke_grid(res: int, seed: int) -> np.ndarray:
    """``procedural_smoke``'s plume density on [0, 1]^3, [res, res, res, 1]
    float32, its random phase drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                          np.linspace(0, 1, res), indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    radius = 0.12 + 0.25 * z + 0.05 * np.sin(10.0 * z + 3.0 * x)
    core = np.exp(-((r / np.maximum(radius, 1e-3)) ** 2) * 4.0)
    swirl = 0.5 + 0.5 * np.sin(8.0 * z + 6.0 * np.arctan2(y - 0.5, x - 0.5)
                               + 2.0 * rng.standard_normal())
    density = core * (0.4 + 0.6 * swirl) * np.clip(1.2 - z, 0.0, 1.0)
    return density.astype(np.float32)[..., None]


def lattice(count: int, init_sigmat: float, init_albedo: float) -> dict:
    """``lattice_init``: count^3 isotropic Gaussians on a lattice in
    [-1, 1)^3, scale 1 / (2 count), as float32 numpy arrays."""
    delta = 1.0 / count
    ax = 2.0 * delta * np.arange(count, dtype=np.float32) - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    centers = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    n = centers.shape[0]
    quats = np.zeros((n, 4), np.float32)
    quats[:, 3] = 1.0
    return dict(centers=centers, scales=np.full((n, 3), delta / 2.0, np.float32), quats=quats,
                sigmat=np.full((n, 1), init_sigmat, np.float32),
                albedo=np.full((n, 3), init_albedo, np.float32))
