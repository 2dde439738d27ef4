"""Synthetic 3DGS / NeRF training-set generation
(volprim_tpu.tooling.dataset).

Icosphere camera rigs, rendered train / test images, Instant-NGP-convention
``transforms_{train,test}.json``, and a seed point cloud sampled from the
primitives (in proportion to opacity x volume); an HDR variant writes the
COLMAP-style layout (EXR renders, exposure brackets, ``sparse/0``
points3D.ply). The rigs, transforms and files are the JAX package's numpy,
unchanged; the point cloud draws from a ``torch.Generator``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from ..scene.cameras import CameraSpecs, look_at
from ..scene.ellipsoids import EllipsoidScene
from ..utils import image as image_io


def _numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def icosphere(subdivisions: int = 1) -> np.ndarray:
    """Unit icosphere vertices: the icosahedron's 12, then each
    subdivision's edge midpoints in order of first use."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    for _ in range(subdivisions):
        mid_cache = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid_cache:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                mid_cache[key] = len(vlist)
                vlist.append(m)
            return mid_cache[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces)
    return verts


def icosphere_rig(
    center,
    radius: float,
    width: int = 800,
    height: int = 800,
    fov: float = 45.0,
    subdivisions: int = 1,
    up=(0, 1, 0),
) -> List[CameraSpecs]:
    """Cameras on an icosphere of ``radius`` around ``center``, each
    looking at the center (``up`` swapped for +x where they align)."""
    center = np.asarray(center, np.float64)
    cams = []
    for i, v in enumerate(icosphere(subdivisions)):
        origin = center + v * radius
        upv = np.asarray(up, np.float64)
        if abs(np.dot(v, upv / np.linalg.norm(upv))) > 0.99:
            upv = np.array([1.0, 0.0, 0.0])
        cams.append(
            CameraSpecs(
                name=f"r_{i}", width=width, height=height,
                to_world=look_at(origin, center, upv), fov=fov,
            )
        )
    return cams


def transforms_dict(cams: List[CameraSpecs]) -> dict:
    """Instant-NGP convention transforms: OpenGL camera frame (x right, y
    up, z backward)."""
    out = {
        "camera_angle_x": float(np.deg2rad(cams[0].fov)),
        "frames": [],
    }
    # Mitsuba local: x left, y up, z forward -> NGP: flip x and z.
    flip = np.diag([-1.0, 1.0, -1.0, 1.0])
    for cam in cams:
        out["frames"].append(
            {
                "file_path": f"./images/{cam.name}",
                "transform_matrix": (cam.to_world @ flip).tolist(),
            }
        )
    return out


def sample_point_cloud(
    prims: EllipsoidScene, count: int, generator: torch.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Initialization point cloud with colors [count, 3] each (numpy),
    sampled from the primitives in proportion to opacity x volume: a
    primitive drawn with replacement from ``generator`` (on the primitives'
    device), then a normal draw in its frame scaled by its scales. The pmf
    is normalised in f64 before its cast to f32. Colors are the DC term x
    ``SH_C0`` + 0.5, clipped to [0, 1] (0.5 without SH coefficients)."""
    vol = prims.scale_prod().detach().cpu().numpy().astype(np.float64)
    opac = prims.attrs.get("opacities")
    w = vol * (opac.detach().cpu().numpy()[:, 0] if opac is not None else 1.0)
    pmf = np.maximum(w, 1e-12)
    pmf /= pmf.sum()
    dev = prims.device
    idx = torch.multinomial(torch.from_numpy(pmf.astype(np.float32)).to(dev), count,
                            replacement=True, generator=generator)
    eps = torch.randn((count, 3), generator=generator, device=dev, dtype=torch.float32)
    with torch.no_grad():
        rot = prims.rotations()[idx]
        local = eps * prims.scales[idx]
        pts = prims.centers[idx] + torch.sum(rot * local[:, None, :], dim=-1)
        if "sh_coeffs" in prims.attrs:
            dc = prims.sh_coeffs_3d()[idx, 0, :].cpu().numpy()
            colors = np.clip(dc * 0.28209479177387814 + 0.5, 0.0, 1.0)
        else:
            colors = np.full((count, 3), 0.5)
    return pts.cpu().numpy(), colors


def generate(
    output: str,
    render_fn: Callable[[CameraSpecs, int], torch.Tensor],
    train_cams: List[CameraSpecs],
    test_cams: Optional[List[CameraSpecs]] = None,
    point_cloud: Optional[tuple] = None,
):
    """Write an Instant-NGP / 3DGS-style dataset: ``images/<name>.png`` and
    ``.npy`` renders, ``transforms_{train,test}.json`` and, optionally, the
    seed cloud as ``points3d.npz``. ``render_fn(camera, index)`` renders
    one camera ([H, W, 3], a tensor or an array)."""
    os.makedirs(os.path.join(output, "images"), exist_ok=True)
    splits = {"train": train_cams}
    if test_cams:
        splits["test"] = test_cams
    for split, cams in splits.items():
        for i, cam in enumerate(cams):
            img = _numpy(render_fn(cam, i))
            image_io.write_image(
                os.path.join(output, "images", f"{cam.name}.png"), img
            )
            np.save(os.path.join(output, "images", f"{cam.name}.npy"), img)
        with open(os.path.join(output, f"transforms_{split}.json"), "w") as f:
            json.dump(transforms_dict(cams), f, indent=2)
    if point_cloud is not None:
        pts, colors = point_cloud
        np.savez(
            os.path.join(output, "points3d.npz"), points=pts, colors=colors
        )


def write_points3d_ply(path: str, points: np.ndarray, colors: np.ndarray,
                       normals: Optional[np.ndarray] = None) -> None:
    """Write a GS / NeRF-style point cloud PLY: f64 positions and normals,
    uchar colors, binary little-endian (open3d's write_point_cloud
    layout)."""
    n = points.shape[0]
    if normals is None:
        normals = np.zeros_like(points)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property double x\nproperty double y\nproperty double z\n"
        "property double nx\nproperty double ny\nproperty double nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(
        n,
        dtype=[(k, "<f8") for k in ("x", "y", "z", "nx", "ny", "nz")]
        + [(k, "u1") for k in ("red", "green", "blue")],
    )
    for i, k in enumerate(("x", "y", "z")):
        rec[k] = points[:, i]
    for i, k in enumerate(("nx", "ny", "nz")):
        rec[k] = normals[:, i]
    c8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = c8[:, i]
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def generate_hdr(
    output: str,
    render_fn: Callable[[CameraSpecs, int], torch.Tensor],
    cams: List[CameraSpecs],
    point_cloud: Optional[tuple] = None,
    exposures: tuple = (0.2, 0.4, 0.6, 0.8, 1.0),
):
    """HDR dataset variant, COLMAP-style layout: exr/<id>.exr HDR renders,
    images/<id>_<e>.png multi-exposure LDR brackets, transforms_train.json
    with intrinsics (w/h/cx/cy), sparse/0/points3D.ply seed cloud."""
    os.makedirs(os.path.join(output, "exr"), exist_ok=True)
    os.makedirs(os.path.join(output, "images"), exist_ok=True)
    os.makedirs(os.path.join(output, "sparse", "0"), exist_ok=True)

    for cam_id, cam in enumerate(cams):
        img = _numpy(render_fn(cam, cam_id))
        image_io.write_image(
            os.path.join(output, "exr", f"{cam_id}.exr"), img
        )
        for exp_id, scale in enumerate(exposures):
            image_io.write_image(
                os.path.join(output, "images", f"{cam_id}_{exp_id}.png"),
                np.clip(img * scale, 0.0, 1.0),
            )

    cam0 = cams[0]
    data = {
        "camera_angle_x": float(np.deg2rad(cam0.fov)),
        "w": cam0.width,
        "h": cam0.height,
        "cx": cam0.width / 2,
        "cy": cam0.height / 2,
        "frames": [],
    }
    flip = np.diag([-1.0, 1.0, -1.0, 1.0])
    for cam_id, cam in enumerate(cams):
        data["frames"].append(
            {
                "file_path": f"{cam_id}",
                "transform_matrix": (
                    cam.to_world.astype(np.float64) @ flip
                ).tolist(),
            }
        )
    with open(os.path.join(output, "transforms_train.json"), "w") as f:
        json.dump(data, f, ensure_ascii=False, indent=4)

    if point_cloud is not None:
        pts, colors = point_cloud
        write_points3d_ply(
            os.path.join(output, "sparse", "0", "points3D.ply"), pts, colors
        )
