"""COLMAP sparse-model readers and writers (volprim_tpu.scene.colmap).

Reads ``cameras.bin/txt`` and ``images.bin/txt`` of a ``sparse/0`` model
directory (intrinsics and extrinsics; the images' 2D point tracks are
skipped) and ``points3D.bin/txt``, and writes the text forms. Plain numpy
and ``struct``: the arithmetic is the JAX package's, unchanged.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params); COLMAP src/colmap/sensor/models.h
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion to rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(r: np.ndarray) -> np.ndarray:
    """Rotation matrix to COLMAP (w, x, y, z) quaternion."""
    m00, m01, m02 = r[0]
    m10, m11, m12 = r[1]
    m20, m21, m22 = r[2]
    k = (
        np.array(
            [
                [m00 - m11 - m22, 0, 0, 0],
                [m01 + m10, m11 - m00 - m22, 0, 0],
                [m02 + m20, m12 + m21, m22 - m00 - m11, 0],
                [m21 - m12, m02 - m20, m10 - m01, m00 + m11 + m22],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(k)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_intrinsics_binary(path: str) -> dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = Camera(cam_id, name, int(width), int(height), params)
    return cameras


def read_extrinsics_binary(path: str) -> dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00" or ch == b"":
                    break
                name += ch
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, 1)  # skip (x, y, point3D_id) records
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode("utf-8")
            )
    return images


def read_intrinsics_text(path: str) -> dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            width, height = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            cameras[cam_id] = Camera(cam_id, model, width, height, params)
    return cameras


def read_extrinsics_text(path: str) -> dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [
            ln.strip()
            for ln in f
            if ln.strip() and not ln.strip().startswith("#")
        ]
    # images.txt alternates: pose line, 2D-points line.
    for ln in lines[0::2]:
        parts = ln.split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name)
    return images


def write_intrinsics_text(cameras: dict[int, Camera], path: str):
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(str(p) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_extrinsics_text(images: dict[int, Image], path: str):
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID, QW QX QY QZ, TX TY TZ, CAMERA_ID, NAME\n")
        for im in images.values():
            q = " ".join(str(v) for v in im.qvec)
            t = " ".join(str(v) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray  # (3,)
    rgb: np.ndarray  # (3,) uint8
    error: float
    image_ids: np.ndarray  # (track,) int32
    point2d_idxs: np.ndarray  # (track,) int32


def read_points3D_binary(path: str) -> dict[int, Point3D]:
    """points3D.bin: the sparse reconstruction's 3D track points (unused
    by the camera loader; for seeding a splat cloud from the SfM points)."""
    points = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            vals = _read(f, "<QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7], dtype=np.uint8)
            error = float(vals[7])
            (track,) = _read(f, "<Q")
            pairs = np.array(_read(f, f"<{2 * track}i")).reshape(-1, 2) if (
                track
            ) else np.zeros((0, 2), np.int32)
            points[pid] = Point3D(
                pid, xyz, rgb, error,
                pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32),
            )
    return points


def read_points3D_text(path: str) -> dict[int, Point3D]:
    """points3D.txt, the text form of :func:`read_points3D_binary`."""
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.array([float(v) for v in parts[1:4]])
            rgb = np.array([int(v) for v in parts[4:7]], dtype=np.uint8)
            error = float(parts[7])
            tr = np.array([int(v) for v in parts[8:]], dtype=np.int32)
            points[pid] = Point3D(
                pid, xyz, rgb, error, tr[0::2].copy(), tr[1::2].copy()
            )
    return points


def write_points3D_text(points: dict[int, Point3D], path: str):
    with open(path, "w") as f:
        f.write(
            "# 3D point list: POINT3D_ID, X Y Z, R G B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        for p in points.values():
            tr = " ".join(
                f"{i} {j}" for i, j in zip(p.image_ids, p.point2d_idxs)
            )
            f.write(
                f"{p.id} {p.xyz[0]} {p.xyz[1]} {p.xyz[2]} "
                f"{p.rgb[0]} {p.rgb[1]} {p.rgb[2]} {p.error} {tr}\n"
            )


def points3D_to_arrays(points: dict[int, Point3D]):
    """(xyz [N, 3] f32, rgb [N, 3] f32 in [0, 1]) — the splat-cloud seed
    shape used by the dataset tooling."""
    ids = sorted(points)
    xyz = np.stack([points[i].xyz for i in ids]).astype(np.float32)
    rgb = (
        np.stack([points[i].rgb for i in ids]).astype(np.float32) / 255.0
    )
    return xyz, rgb
