"""Synthetic scenes made from a seed with numpy (no download, no JAX).

- ``make_scene``: the trained-3DGS-like surface scene, the same as
  ``bench.make_scene(n, kind="surface")`` in the JAX package, bit for bit:
  thin anisotropic splats tangent to three bumpy spheres plus a ground
  sheet on y = -1, opacities in [0.55, 0.99] and degree-1 SH (k = 4
  coefficients per channel).
- ``headline_camera``: bench.py's headline camera; ``orbit_cameras``: it
  and more on its orbit.
- ``make_medium``: the "plume", a scattering medium of Gaussian primitives
  for the path tracer, drawn from the closed-form plume density of the JAX
  package's ``scene.vol.procedural_smoke`` (its stand-in for the missing
  ``smoke.vol``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ellipsoids import EllipsoidScene


def _orient_quats(normals: np.ndarray, rng) -> np.ndarray:
    """Quats rotating local +z onto each normal, with random spin."""
    n = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    z = np.array([0.0, 0.0, 1.0])
    # quaternion from z to n: axis = z x n, w = 1 + z.n
    axis = np.cross(np.broadcast_to(z, n.shape), n)
    w = 1.0 + n[:, 2:3]
    q = np.concatenate([axis, w], axis=1)
    # degenerate (n = -z): rotate around x
    bad = w[:, 0] < 1e-6
    q[bad] = [1.0, 0.0, 0.0, 0.0]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # random spin about the normal
    ang = rng.uniform(0, np.pi, size=(n.shape[0], 1))
    spin = np.concatenate([np.sin(ang) * n, np.cos(ang)], axis=1)
    # quaternion product spin * q  (x,y,z,w layout)
    x1, y1, z1, w1 = spin.T
    x2, y2, z2, w2 = q.T
    out = np.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=1,
    )
    return out.astype(np.float32)


def make_scene_arrays(n_prims: int, seed: int = 0) -> dict:
    """The surface scene as numpy arrays: centers, scales, quats, opacities,
    sh_coeffs (all float32)."""
    rng = np.random.default_rng(seed)
    n_ground = n_prims // 4
    n_obj = n_prims - n_ground
    # ground sheet on y = -1
    gx = rng.uniform(-3, 3, size=n_ground)
    gz = rng.uniform(-3, 3, size=n_ground)
    gy = np.full(n_ground, -1.0) + rng.normal(size=n_ground) * 0.005
    g_centers = np.stack([gx, gy, gz], axis=-1)
    g_normals = np.tile([0.0, 1.0, 0.0], (n_ground, 1))
    g_normals += rng.normal(size=(n_ground, 3)) * 0.05
    # three blobby objects (bumpy spheres)
    obj_centers, obj_normals = [], []
    params = [([-1.1, -0.25, 0.3], 0.75), ([1.0, -0.1, -0.2], 0.9),
              ([0.0, 0.35, 1.0], 0.65)]
    per = n_obj // len(params)
    for (c, r0) in params:
        dirs = rng.normal(size=(per, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        # bumpy radius: low-frequency lobes
        bump = 1.0 + 0.18 * np.sin(4.1 * dirs[:, 0] + 1.2) * np.cos(
            3.3 * dirs[:, 1]
        ) + 0.12 * np.sin(5.7 * dirs[:, 2])
        obj_centers.append(np.asarray(c) + dirs * (r0 * bump[:, None]))
        obj_normals.append(dirs)
    rem = n_obj - per * len(params)
    if rem:
        obj_centers.append(obj_centers[0][:rem])
        obj_normals.append(obj_normals[0][:rem])
    centers = np.concatenate([g_centers] + obj_centers).astype(np.float32)
    normals = np.concatenate([g_normals] + obj_normals).astype(np.float32)
    quats = _orient_quats(normals, rng)
    # Thin tangent splats sized so ~3-5 splats overlap any surface point:
    # sigma such that density * pi * (2 sigma)^2 ~ 4 for each region.
    sig = np.empty((n_prims,), np.float64)
    sig[:n_ground] = np.sqrt(4.0 / (n_ground / 36.0) / np.pi) / 2.0
    sig[n_ground:] = np.sqrt(4.0 / (n_obj / 30.0) / np.pi) / 2.0
    tangent = sig[:, None] * np.exp(rng.normal(0.0, 0.3, size=(n_prims, 2)))
    normal_s = tangent[:, :1] * rng.uniform(0.08, 0.25, size=(n_prims, 1))
    scales = np.concatenate([tangent, normal_s], axis=1).astype(np.float32)

    f_dc = rng.normal(size=(n_prims, 3)).astype(np.float32) * 0.3
    f_rest = rng.normal(size=(n_prims, 9)).astype(np.float32) * 0.1
    opac = rng.uniform(0.55, 0.99, size=(n_prims, 1)).astype(np.float32)
    return dict(
        centers=centers, scales=scales, quats=quats, opacities=opac,
        sh_coeffs=np.concatenate([f_dc, f_rest], axis=1),
    )


def make_scene(n_prims: int, seed: int = 0, device=None) -> EllipsoidScene:
    """The surface scene as an :class:`EllipsoidScene` on ``device``."""
    from .. import as_device

    dev = as_device(device)
    a = make_scene_arrays(n_prims, seed)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return EllipsoidScene(
        centers=t(a["centers"]), scales=t(a["scales"]), quats=t(a["quats"]),
        attrs={"opacities": t(a["opacities"]), "sh_coeffs": t(a["sh_coeffs"])},
    )


def headline_camera(width: int = 512):
    """bench.py's headline camera (eye (0, 0.4, -3.2) looking at the origin,
    fov 50) on a square film of ``width``."""
    from .cameras import CameraSpecs, look_at

    return CameraSpecs(name="bench", width=width, height=width,
                       to_world=look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]), fov=50.0)


def orbit_cameras(width: int = 512, count: int = 8, fov: float = 50.0) -> list:
    """bench.py's headline camera (eye (0, 0.4, -3.2), looking at the
    origin) followed by ``count - 1`` more on its orbit: the eye turned
    about the y axis in equal steps, square films of ``width``."""
    from .cameras import CameraSpecs, look_at

    cams = []
    for i in range(count):
        ang = 2.0 * np.pi * i / count
        eye = [-3.2 * np.sin(ang), 0.4, -3.2 * np.cos(ang)]
        cams.append(CameraSpecs(name="bench" if i == 0 else f"orbit_{i:02d}", width=width,
                                height=width, to_world=look_at(eye, [0, 0, 0], [0, 1, 0]),
                                fov=fov))
    return cams


# sigma_t scale of the plume, chosen once so that the median optical depth
# (prb.optical_depth) of the central 64 x 64 unjittered rays of medium_camera()
# at 512 x 512 lies in [1, 4]: most camera rays scatter, a fair share escape.
MEDIUM_SIGMA = 1.5e-3


def plume_density(x, y, z, phase: float):
    """The closed-form plume on [0, 1]^3 (vol.procedural_smoke): a swirling
    core whose radius grows with z, fading out towards z = 1.2. Values lie
    in [0, 1]."""
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    radius = 0.12 + 0.25 * z + 0.05 * np.sin(10.0 * z + 3.0 * x)
    core = np.exp(-((r / np.maximum(radius, 1e-3)) ** 2) * 4.0)
    swirl = 0.5 + 0.5 * np.sin(8.0 * z + 6.0 * np.arctan2(y - 0.5, x - 0.5) + phase)
    return core * (0.4 + 0.6 * swirl) * np.clip(1.2 - z, 0.0, 1.0)


def make_medium_arrays(n_prims: int = 4096, seed: int = 0) -> dict:
    """The plume as float32 numpy arrays: centers, scales, quats, albedo
    [N, 3] and sigma_t [N, 1]. Centers are drawn by rejection sampling of
    the plume density (u ~ U[0, 1]^3 accepted with probability rho(u)) and
    mapped to world (2u_x - 1, 2u_z - 1, 2u_y - 1), so the plume rises
    along +y; each primitive's sigma_t is MEDIUM_SIGMA * rho(u)."""
    rng = np.random.default_rng(seed)
    phase = 2.0 * rng.standard_normal()  # the plume's random phase, first
    us, rhos, n = [], [], 0
    while n < n_prims:
        u = rng.uniform(size=(4 * n_prims, 3))
        rho = plume_density(u[:, 0], u[:, 1], u[:, 2], phase)
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
    return dict(
        centers=f32(centers), scales=f32(scales), quats=f32(quats), albedo=f32(albedo),
        sigma_t=f32(MEDIUM_SIGMA * rho[:, None]),
    )


def make_medium(n_prims: int = 4096, seed: int = 0, device=None) -> EllipsoidScene:
    """The plume as an :class:`EllipsoidScene` (extent 3) on ``device``."""
    from .. import as_device

    dev = as_device(device)
    a = make_medium_arrays(n_prims, seed)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return EllipsoidScene(
        centers=t(a["centers"]), scales=t(a["scales"]), quats=t(a["quats"]),
        attrs={"sigma_t": t(a["sigma_t"]), "albedo": t(a["albedo"])}, extent=3.0,
    )


def medium_camera(width: int = 512, height: int = 512):
    """The camera of ``examples/render_volume.py`` (fov 40) at this film."""
    from .cameras import CameraSpecs, look_at

    return CameraSpecs(
        name="cam", width=width, height=height,
        to_world=look_at(
            origin=[-3.98825, -0.306404, -1.74332e-07],
            target=[-2.99119, -0.229803, -1.30749e-07],
            up=[-0.076601, 0.997062, -3.34833e-09],
        ),
        fov=40.0,
    )
