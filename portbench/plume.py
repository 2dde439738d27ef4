"""Inputs of the path-traced cell, made from ``--seed`` by the benchmark's
own code: frozen numpy copies of the port's plume (``scene/synthetic.
make_medium_arrays``: 4,096 Gaussians by rejection sampling of the
procedural smoke density), its procedural dusk sky (``ops/envmap.
procedural_sky``) and the camera of ``examples/render_volume.py``
(``scene/synthetic.medium_camera``). A change to the port therefore cannot
change what the port is given, and the reference takes nothing that the
port has made. Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

from portbench import inputs

MEDIUM_SIGMA = 1.5e-3
# the camera of upstream's render_volume.py (fov 40, looking along +x)
CAMERA = dict(origin=[-3.98825, -0.306404, -1.74332e-07],
              target=[-2.99119, -0.229803, -1.30749e-07],
              up=[-0.076601, 0.997062, -3.34833e-09], fov=40.0)


def _density(x, y, z, phase: float):
    """The closed-form plume on [0, 1]^3, values in [0, 1]."""
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    radius = 0.12 + 0.25 * z + 0.05 * np.sin(10.0 * z + 3.0 * x)
    core = np.exp(-((r / np.maximum(radius, 1e-3)) ** 2) * 4.0)
    swirl = 0.5 + 0.5 * np.sin(8.0 * z + 6.0 * np.arctan2(y - 0.5, x - 0.5) + phase)
    return core * (0.4 + 0.6 * swirl) * np.clip(1.2 - z, 0.0, 1.0)


def plume(n_prims: int, seed: int, sigmat_scale: float) -> dict:
    """The plume as float32 numpy arrays (centers, scales, quats, albedo
    [N, 3], sigma_t [N, 1]), its sigma_t times ``sigmat_scale``: centers by
    rejection sampling of the density mapped to world (2u_x - 1, 2u_z - 1,
    2u_y - 1), log-uniform scales in [0.02, 0.06], random unit quaternions,
    albedo in [0.6, 0.95]."""
    rng = np.random.default_rng(seed % 2 ** 64)
    phase = 2.0 * rng.standard_normal()
    us, rhos, n = [], [], 0
    while n < n_prims:
        u = rng.uniform(size=(4 * n_prims, 3))
        rho = _density(u[:, 0], u[:, 1], u[:, 2], phase)
        keep = rng.uniform(size=4 * n_prims) < rho
        us.append(u[keep])
        rhos.append(rho[keep])
        n += int(keep.sum())
    u = np.concatenate(us)[:n_prims]
    rho = np.concatenate(rhos)[:n_prims]
    centers = np.stack([2 * u[:, 0] - 1, 2 * u[:, 2] - 1, 2 * u[:, 1] - 1], axis=1)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.06), size=(n_prims, 3)))
    quats = rng.normal(size=(n_prims, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    albedo = rng.uniform(0.6, 0.95, size=(n_prims, 3))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    sigma_t = f32(MEDIUM_SIGMA * rho[:, None]) * np.float32(sigmat_scale)
    return dict(centers=f32(centers), scales=f32(scales), quats=f32(quats), albedo=f32(albedo),
                sigma_t=sigma_t)


def sky(h: int = 128, w: int = 256) -> np.ndarray:
    """The procedural dusk sky [h, w, 3] float32: a horizon gradient plus a
    bright sun disk."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    t, p = np.meshgrid(theta, phi, indexing="ij")
    horizon = np.exp(-(((t - np.pi / 2) / 0.35) ** 2))
    sky_ = np.clip(np.cos(t), 0.0, 1.0)
    sun_dir = np.array([np.sin(1.4) * np.sin(1.0), np.cos(1.4), -np.sin(1.4) * np.cos(1.0)])
    d = np.stack([np.sin(t) * np.sin(p), np.cos(t), -np.sin(t) * np.cos(p)], axis=-1)
    cos_sun = np.clip(d @ sun_dir, 0.0, 1.0)
    sun = np.power(cos_sun, 2000.0) * 500.0
    return np.stack([0.25 * sky_ + 0.9 * horizon + sun, 0.3 * sky_ + 0.45 * horizon + 0.9 * sun,
                     0.5 * sky_ + 0.25 * horizon + 0.7 * sun], axis=-1).astype(np.float32)


def camera(width: int, height: int) -> dict:
    """The camera as a plain dict (width, height, to_world, fov)."""
    return dict(width=width, height=height, fov=CAMERA["fov"],
                to_world=inputs.look_at(CAMERA["origin"], CAMERA["target"], CAMERA["up"]))
