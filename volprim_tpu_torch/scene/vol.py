"""Grid volumes (volprim_tpu.scene.vol): Mitsuba's ``.vol`` binary format
and a trilinear grid sampler.

Format: bytes 'VOL', uint8 version 3, int32 encoding (1 = float32), int32
(xres, yres, zres), int32 channels, 6 float32 bbox (xmin ymin zmin xmax
ymax zmax), then xres * yres * zres * channels float32 with x varying
fastest. The files are byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch


@dataclasses.dataclass
class GridVolume:
    data: torch.Tensor  # [zres, yres, xres, channels]
    bbox_min: torch.Tensor  # [3]
    bbox_max: torch.Tensor  # [3]

    @property
    def resolution(self):
        return self.data.shape[2], self.data.shape[1], self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_arrays(data, bbox_min, bbox_max, device=None) -> "GridVolume":
        """A grid from float32 arrays (``data`` [zres, yres, xres, C], the
        bbox corners [3]) on ``device`` (the card unless the caller asks for
        the CPU)."""
        from .. import as_device

        dev = as_device(device)

        def t(x):
            return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)  # a writable copy

        return GridVolume(t(data), t(bbox_min), t(bbox_max))

    def to(self, device) -> "GridVolume":
        return GridVolume(self.data.to(device), self.bbox_min.to(device),
                          self.bbox_max.to(device))

    def sample(self, p: torch.Tensor) -> torch.Tensor:
        """Trilinear sample at world points ``p`` [..., 3] -> [..., C]; zero
        outside the bbox (both faces inside). Cell centres sit at the
        corners of the [0, 1]^3 local cube (Mitsuba's gridvolume, 'raw'
        data). The eight corners are one gather through a flat index into
        ``data`` viewed as [zres * yres * xres, C]; the blend is the JAX
        package's, x, then y, then z."""
        local = (p - self.bbox_min) / (self.bbox_max - self.bbox_min)
        inside = torch.all((local >= 0.0) & (local <= 1.0), dim=-1)
        nx, ny, nz = self.resolution
        f = [local[..., i] * (n - 1) for i, n in enumerate((nx, ny, nz))]
        lo = [torch.clamp(torch.floor(fi).to(torch.int64), 0, n - 1)
              for fi, n in zip(f, (nx, ny, nz))]
        ix, iy, iz = (torch.stack([li, torch.clamp(li + 1, max=n - 1)], dim=-1)
                      for li, n in zip(lo, (nx, ny, nz)))
        tx, ty, tz = ((fi - li.to(fi.dtype))[..., None] for fi, li in zip(f, lo))
        flat = (iz[..., :, None, None] * ny + iy[..., None, :, None]) * nx + ix[..., None, None, :]
        c = self.data.reshape(-1, self.data.shape[-1])[flat]  # [..., z, y, x, C]
        c = c[..., 0, :] * (1 - tx[..., None, None, :]) + c[..., 1, :] * tx[..., None, None, :]
        c = c[..., 0, :] * (1 - ty[..., None, :]) + c[..., 1, :] * ty[..., None, :]
        out = c[..., 0, :] * (1 - tz) + c[..., 1, :] * tz
        return torch.where(inside[..., None], out, 0.0)


def load_vol(path: str, device=None) -> GridVolume:
    """The grid in a ``.vol`` file, on ``device`` (the card unless the
    caller asks for the CPU)."""
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"VOL":
            raise ValueError(f"{path}: not a .vol file: {magic!r}")
        (version,) = struct.unpack("<B", f.read(1))
        if version != 3:
            raise ValueError(f"{path}: unsupported .vol version {version}")
        (encoding,) = struct.unpack("<i", f.read(4))
        if encoding != 1:
            raise ValueError(f"{path}: only float32 .vol grids are supported")
        xres, yres, zres = struct.unpack("<3i", f.read(12))
        (channels,) = struct.unpack("<i", f.read(4))
        bbox = struct.unpack("<6f", f.read(24))
        data = np.frombuffer(
            f.read(4 * xres * yres * zres * channels), dtype="<f4"
        ).reshape(zres, yres, xres, channels)
    return GridVolume.from_arrays(data, bbox[:3], bbox[3:], device)


def save_vol(grid: GridVolume, path: str) -> None:
    data = grid.data.detach().cpu().numpy().astype(np.float32)
    zres, yres, xres, channels = data.shape
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(struct.pack("<B", 3))
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<3i", xres, yres, zres))
        f.write(struct.pack("<i", channels))
        bbox = [*grid.bbox_min.detach().cpu().numpy(), *grid.bbox_max.detach().cpu().numpy()]
        f.write(struct.pack("<6f", *bbox))
        f.write(np.ascontiguousarray(data, "<f4").tobytes())


def procedural_smoke(res: int = 48, seed: int = 0, device=None) -> GridVolume:
    """A plume-like density field on [0, 1]^3 (res^3, one channel), the
    stand-in for Mitsuba's ``smoke.vol``; numpy-made, equal to the JAX
    package's bit for bit. On ``device`` (the card unless the caller asks
    for the CPU)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(
        np.linspace(0, 1, res), np.linspace(0, 1, res), np.linspace(0, 1, res),
        indexing="ij",
    )
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    radius = 0.12 + 0.25 * z + 0.05 * np.sin(10.0 * z + 3.0 * x)
    core = np.exp(-((r / np.maximum(radius, 1e-3)) ** 2) * 4.0)
    swirl = 0.5 + 0.5 * np.sin(
        8.0 * z + 6.0 * np.arctan2(y - 0.5, x - 0.5) + 2.0 * rng.standard_normal()
    )
    density = core * (0.4 + 0.6 * swirl) * np.clip(1.2 - z, 0.0, 1.0)
    density = density.astype(np.float32)[..., None]
    return GridVolume.from_arrays(density, [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], device)
