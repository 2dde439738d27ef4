"""Headless mesh inspection images (volprim_tpu.tooling.visualizer).

The same inspection an interactive viewer gives, rendered to images with
the port's own triangle-mesh intersector:

- :func:`render_mesh_attribute`: ray-trace the mesh from a camera and shade
  each hit with an interpolated vertex attribute (scalars through a
  viridis-like ramp), depth-correct, with a headlight term so the geometry
  reads;
- :func:`draw_rays` / :func:`draw_points`: project world-space segments /
  points into the image;
- :func:`visualize` bundles them and writes the image.

Rays are traced on the mesh's device; the overlays are drawn in numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..scene import mesh as mesh_mod
from ..scene.cameras import CameraSpecs, generate_rays


def render_mesh_attribute(
    mesh: mesh_mod.TriangleMesh,
    camera: CameraSpecs,
    attr: Optional[str] = None,
    cmap_lo: float = 0.0,
    cmap_hi: float = 1.0,
    headlight: float = 0.35,
    background=(1.0, 1.0, 1.0),
) -> np.ndarray:
    """Ray-traced attribute view of a mesh. Returns an [H, W, 3] float image.

    ``attr``: vertex-attribute name (1 or 3 channels; scalars map through
    a viridis-like ramp between cmap_lo and cmap_hi). None shades by the
    face normals only.
    """
    o, d = generate_rays(camera, jitter=False, device=mesh.device)
    valid, t, fid, bary = mesh_mod.intersect(mesh, o, d, t_min=1e-4)
    h, w = camera.height, camera.width

    n = mesh.face_normals()[fid]
    lambert = torch.abs(torch.sum(n * -d, dim=-1))[:, None]

    if attr is not None:
        v = mesh.interpolate(attr, fid, bary)
        if v.shape[-1] == 3:
            color = torch.clamp(v, 0.0, 1.0)
        else:
            x = torch.clamp((v[:, 0] - cmap_lo) / max(cmap_hi - cmap_lo, 1e-9), 0.0, 1.0)
            # compact viridis-ish ramp
            color = torch.stack(
                [
                    0.267 + x * (0.993 - 0.267) * x,
                    0.005 + 0.86 * x,
                    0.329 + 0.31 * x - 0.495 * x * x,
                ],
                dim=-1,
            )
            color = torch.clamp(color, 0.0, 1.0)
    else:
        color = 0.5 * (n + 1.0)

    shade = color * ((1.0 - headlight) + headlight * lambert)
    bg = torch.as_tensor(background, dtype=torch.float32, device=shade.device)
    img = torch.where(valid[:, None], shade, bg)
    return img.cpu().numpy().reshape(h, w, 3)


def _project(camera: CameraSpecs, pts: np.ndarray) -> np.ndarray:
    """World points [N, 3] -> pixel coords [N, 2] (+ depth in column 2)."""
    m = np.asarray(camera.to_world, np.float64)
    r, tvec = m[:3, :3], m[:3, 3]
    local = (np.asarray(pts, np.float64) - tvec) @ r  # camera frame
    z = np.maximum(local[:, 2], 1e-9)
    f = float(camera.focal_length)
    px = camera.width / 2.0 - camera.cx - f * local[:, 0] / z
    py = camera.height / 2.0 - camera.cy - f * local[:, 1] / z
    return np.stack([px, py, z], axis=-1)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def draw_points(
    img: np.ndarray, camera: CameraSpecs, pts, color=(1.0, 0.1, 0.1), radius: int = 1,
) -> np.ndarray:
    """Splat world-space points into the image."""
    img = np.array(img, copy=True)
    pc = _project(camera, _numpy(pts))
    h, w = img.shape[:2]
    for x, y, z in pc:
        if z <= 0:
            continue
        xi, yi = int(round(x)), int(round(y))
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                if 0 <= yi + dy < h and 0 <= xi + dx < w:
                    img[yi + dy, xi + dx] = color
    return img


def draw_rays(
    img: np.ndarray, camera: CameraSpecs, origins, dirs, length: float = 1.0,
    color=(0.1, 0.4, 1.0),
) -> np.ndarray:
    """Project ray segments into the image."""
    img = np.array(img, copy=True)
    o = _numpy(origins)
    e = o + _numpy(dirs) * length
    p0 = _project(camera, o)
    p1 = _project(camera, e)
    h, w = img.shape[:2]
    for (x0, y0, z0), (x1, y1, z1) in zip(p0, p1):
        if z0 <= 0 and z1 <= 0:
            continue
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
        for i in range(n + 1):
            s = i / n
            x = x0 + (x1 - x0) * s
            y = y0 + (y1 - y0) * s
            xi, yi = int(round(x)), int(round(y))
            if 0 <= yi < h and 0 <= xi < w:
                img[yi, xi] = color
    return img


def visualize(
    path: str,
    mesh: mesh_mod.TriangleMesh,
    camera: CameraSpecs,
    attr: Optional[str] = None,
    points=None,
    rays: Optional[tuple] = None,
    **kw,
) -> np.ndarray:
    """One-call inspection image: the mesh attribute with optional
    overlays, written to ``path`` (PNG or EXR through utils.image)."""
    from ..utils.image import write_image

    img = render_mesh_attribute(mesh, camera, attr, **kw)
    if points is not None:
        img = draw_points(img, camera, points)
    if rays is not None:
        img = draw_rays(img, camera, rays[0], rays[1], *(rays[2:] if len(rays) > 2 else ()))
    write_image(path, img)
    return img
