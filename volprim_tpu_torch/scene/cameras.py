"""Camera records, their JSON / KRT / COLMAP loaders and primary-ray
generation (volprim_tpu.scene.cameras).

Mitsuba convention: the camera's local +x points image-left, +y image-up,
+z along the view direction; pixel (0, 0) is the top-left of the film.
3DGS's ``cameras.json`` uses +x right, +y down: its loader and writer flip
the first two axes.
Jitter draws from an explicit ``torch.Generator``; it does not reproduce
``jax.random`` bits, so parity checks render with ``jitter=False``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch

from . import colmap as colmap_loader


def fov2focal(fov_deg: float, width: int) -> float:
    """Focal length in pixels from the x-axis FOV in degrees."""
    return (width / 2.0) / np.tan(np.deg2rad(fov_deg) * 0.5)


def focal2fov(focal_length: float, width: int) -> float:
    """FOV in degrees from the focal length in pixels."""
    return float(2.0 * np.rad2deg(np.arctan2(0.5 * width, focal_length)))


def look_at(origin, target, up) -> np.ndarray:
    """Mitsuba-convention look_at to_world matrix (x left, y up, z forward)."""
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(target, np.float64) - origin
    direction = direction / np.linalg.norm(direction)
    left = np.cross(np.asarray(up, np.float64), direction)
    left = left / np.linalg.norm(left)
    new_up = np.cross(direction, left)
    m = np.eye(4)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = direction
    m[:3, 3] = origin
    return m


def rotate_x(deg: float) -> np.ndarray:
    """4x4 rotation by ``deg`` degrees about the x axis."""
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y(deg: float) -> np.ndarray:
    """4x4 rotation by ``deg`` degrees about the y axis."""
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


@dataclasses.dataclass
class CameraSpecs:
    """Pinhole camera; ``cx, cy`` are principal-point offsets in pixels (the
    principal point is ``(W/2 - cx, H/2 - cy)``). The fields and their order
    are the JAX package's (volprim_tpu/scene/cameras.py), so positional
    construction means the same in both: the clip planes and the radial
    (k1-k6) and tangential (p1, p2) distortion are carried, not applied to
    rays, as there."""

    name: str
    width: int
    height: int
    to_world: np.ndarray  # 4x4, Mitsuba convention
    fov: Optional[float] = None  # degrees, x axis
    focal_length: Optional[float] = None  # pixels
    near_clip: float = 0.1
    far_clip: float = 10000.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def __post_init__(self):
        self.to_world = np.asarray(self.to_world, np.float64).reshape(4, 4)
        if self.fov is None and self.focal_length is None:
            raise ValueError("either fov or focal_length must be set")
        if self.fov is None:
            self.fov = focal2fov(self.focal_length, self.width)
        elif self.focal_length is None:
            self.focal_length = fov2focal(self.fov, self.width)

    def viewmat(self) -> np.ndarray:
        """World-to-camera matrix in the GSplat convention (x right, y down)."""
        flip = np.diag([-1.0, -1.0, 1.0, 1.0])
        return np.linalg.inv(self.to_world @ flip)

    def K(self) -> np.ndarray:
        """Intrinsics matrix, the principal point at the film's center."""
        return np.array(
            [
                [self.focal_length, 0.0, self.width / 2.0],
                [0.0, self.focal_length, self.height / 2.0],
                [0.0, 0.0, 1.0],
            ]
        )

    def scaled(self, factor: float) -> "CameraSpecs":
        """A copy with the film, focal length and principal-point offsets
        scaled by ``factor`` (the fov follows from the focal length)."""
        return dataclasses.replace(
            self,
            width=int(self.width * factor),
            height=int(self.height * factor),
            focal_length=self.focal_length * factor,
            fov=None,
            cx=self.cx * factor,
            cy=self.cy * factor,
        )

    def to_dict(self) -> dict:
        return {
            "type": "perspective",
            "name": self.name,
            "fov": self.fov,
            "width": self.width,
            "height": self.height,
            "to_world": self.to_world.tolist(),
            "near_clip": self.near_clip,
            "far_clip": self.far_clip,
            "principal_point_offset_x": self.cx,
            "principal_point_offset_y": self.cy,
        }

    @staticmethod
    def from_dict(d: dict, name: str = "") -> "CameraSpecs":
        return CameraSpecs(
            name=d.get("name", name),
            width=int(d["width"]),
            height=int(d["height"]),
            to_world=np.asarray(d["to_world"]),
            fov=d.get("fov"),
            focal_length=d.get("focal_length"),
            near_clip=d.get("near_clip", 0.1),
            far_clip=d.get("far_clip", 10000.0),
            cx=d.get("principal_point_offset_x", 0.0),
            cy=d.get("principal_point_offset_y", 0.0),
        )


def rays_from_pixels(spec: CameraSpecs, px: torch.Tensor, py: torch.Tensor):
    """Rays through continuous film positions (px, py) -> (o, d) [..., 3]."""
    dev = px.device
    f = torch.tensor(spec.focal_length, dtype=torch.float32, device=dev)
    ppx = torch.tensor(spec.width / 2.0 - spec.cx, dtype=torch.float32, device=dev)
    ppy = torch.tensor(spec.height / 2.0 - spec.cy, dtype=torch.float32, device=dev)
    d_local = torch.stack(
        [-(px - ppx) / f, -(py - ppy) / f, torch.ones_like(px)], dim=-1
    )
    rot = torch.as_tensor(spec.to_world[:3, :3], dtype=torch.float32, device=dev)
    origin = torch.as_tensor(spec.to_world[:3, 3], dtype=torch.float32, device=dev)
    # d_local @ rot.T, summed in a fixed order (full f32, no matmul backend)
    d_world = torch.stack(
        [
            d_local[..., 0] * rot[i, 0]
            + d_local[..., 1] * rot[i, 1]
            + d_local[..., 2] * rot[i, 2]
            for i in range(3)
        ],
        dim=-1,
    )
    d_world = d_world / torch.sqrt(torch.sum(d_world * d_world, -1, keepdim=True))
    return origin.expand(d_world.shape), d_world


def film_coords(
    spec: CameraSpecs,
    generator: Optional[torch.Generator] = None,
    jitter: bool = True,
    device=None,
):
    """Continuous film coordinates (px, py) [H*W], one per pixel, row-major.
    With ``jitter`` the in-pixel offset is drawn from ``generator``;
    otherwise they are the pixel centers."""
    from .. import as_device

    dev = as_device(device)
    h, w = spec.height, spec.width
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w).reshape(-1)
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
    if jitter:
        off = torch.rand(
            (px.shape[0], 2), generator=generator, device=dev, dtype=torch.float32
        )
        return px + off[:, 0], py + off[:, 1]
    return px + 0.5, py + 0.5


def generate_rays(
    spec: CameraSpecs,
    generator: Optional[torch.Generator] = None,
    jitter: bool = True,
    device=None,
):
    """One primary ray per pixel, row-major: (origins, directions) [H*W, 3],
    through :func:`film_coords`."""
    return rays_from_pixels(spec, *film_coords(spec, generator, jitter, device))


_FLIP_XY = np.diag([-1.0, -1.0, 1.0, 1.0])


class JSONCameraSpecsIO:
    """3DGS ``cameras.json`` loader and writer, with the handedness flip."""

    @staticmethod
    def load(filename: str) -> List[CameraSpecs]:
        with open(filename) as f:
            sensors = json.load(f)
        specs = []
        for sensor in sensors:
            to_world = np.eye(4)
            to_world[:3, :3] = np.asarray(sensor["rotation"])
            to_world[:3, 3] = np.asarray(sensor["position"])
            specs.append(CameraSpecs(
                name=sensor["img_name"], width=sensor["width"], height=sensor["height"],
                focal_length=sensor["fx"], to_world=to_world @ _FLIP_XY,
                near_clip=0.1, far_clip=100.0,
            ))
        return specs

    @staticmethod
    def write(specs: List[CameraSpecs], filename: str) -> None:
        sensors = []
        for i, cam in enumerate(specs):
            to_world = cam.to_world @ _FLIP_XY
            sensors.append({
                "rotation": to_world[:3, :3].tolist(),
                "position": to_world[:3, 3].tolist(),
                "fx": cam.focal_length,
                "fy": cam.focal_length,
                "width": cam.width,
                "height": cam.height,
                "id": i,
                "img_name": cam.name,
            })
        with open(filename, "w", encoding="utf-8") as f:
            f.write(json.dumps(sensors, ensure_ascii=False))


class KRTCameraSpecsIO:
    """KRT JSON loader (pinhole cameras with radial and tangential
    distortion only; K is stored transposed, the principal point in row 2)."""

    @staticmethod
    def load(filename: str, faithful: bool = True) -> List[CameraSpecs]:
        """``faithful=True`` keeps the reference's reading of ``K[2, 1]`` for
        both principal-point coordinates, so the width derives from the
        point's y (wrong for non-square sensors); ``faithful=False`` reads
        ``K[2, 0], K[2, 1]``."""
        with open(filename) as f:
            sensors = json.load(f)["KRT"]
        infos = []
        for sensor in sensors:
            if sensor.get("distortionModel") != "RadialAndTangential":
                continue
            if sensor.get("projectionModel") != "Pinhole":
                continue
            k_mat = np.asarray(sensor["K"])
            k1, k2, k3, k4 = list(sensor["distortion"][0])
            px, py = (k_mat[2, 1], k_mat[2, 1]) if faithful else (k_mat[2, 0], k_mat[2, 1])
            infos.append(CameraSpecs(
                name=sensor["cameraId"], width=int(2 * px), height=int(2 * py),
                to_world=np.asarray(sensor["T"]), focal_length=k_mat[0, 0],
                k1=k1, k2=k2, k3=k3, k4=k4,
            ))
        return infos


# (fx, cx, cy) and the distortion fields by COLMAP camera model: the index
# of each parameter in the model's list
_COLMAP_PARAMS = {
    "SIMPLE_PINHOLE": dict(fx=0, cx=1, cy=2),
    "PINHOLE": dict(fx=0, cx=2, cy=3),
    "SIMPLE_RADIAL": dict(fx=0, cx=1, cy=2, k1=3),
    "RADIAL": dict(fx=0, cx=1, cy=2, k1=3, k2=4),
    "OPENCV": dict(fx=0, cx=2, cy=3, k1=4, k2=5, p1=6, p2=7),
    "OPENCV_FISHEYE": dict(fx=0, cx=2, cy=3, k1=4, k2=5, k3=6, k4=7),
    "FULL_OPENCV": dict(fx=0, cx=2, cy=3, k1=4, k2=5, p1=6, p2=7, k3=8, k4=9, k5=10, k6=11),
}


class ColmapCameraSpecsIO:
    """COLMAP ``sparse/0`` model loader: binary files, or the text ones
    where the binary ones are missing. The principal point is stored as
    the offset ``width / 2 - cx`` (and likewise y)."""

    @staticmethod
    def load(path: str) -> List[CameraSpecs]:
        base = os.path.join(path, "sparse", "0")
        try:
            extr = colmap_loader.read_extrinsics_binary(os.path.join(base, "images.bin"))
            intr = colmap_loader.read_intrinsics_binary(os.path.join(base, "cameras.bin"))
        except (FileNotFoundError, OSError):
            extr = colmap_loader.read_extrinsics_text(os.path.join(base, "images.txt"))
            intr = colmap_loader.read_intrinsics_text(os.path.join(base, "cameras.txt"))

        infos = []
        for key in extr:
            e = extr[key]
            i = intr[e.camera_id]
            layout = _COLMAP_PARAMS.get(i.model)
            if layout is None:
                raise ValueError(f"COLMAP camera model not handled: {i.model}")
            v = {name: i.params[j] for name, j in layout.items()}
            dist = {k: v.get(k, 0.0) for k in ("k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2")}

            # COLMAP's world-to-camera (x right, y down) -> Mitsuba to_world
            rot = colmap_loader.qvec2rotmat(e.qvec).T
            to_cam = np.eye(4)
            to_cam[:3, :3] = rot * np.array([-1.0, -1.0, 1.0])
            to_cam[3, :3] = np.asarray(e.tvec) * np.array([-1.0, -1.0, 1.0])
            to_world = np.linalg.inv(to_cam).T

            infos.append(CameraSpecs(
                name=e.name.replace(".", "_"), width=i.width, height=i.height,
                to_world=to_world, focal_length=v["fx"],
                cx=i.width / 2.0 - v["cx"], cy=i.height / 2.0 - v["cy"], **dist,
            ))
        return infos
