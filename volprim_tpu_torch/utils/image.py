"""Image I/O without imaging libraries (volprim_tpu.utils.image): EXR
(uncompressed float32 scanlines, readable by OpenEXR tools), PNG (stdlib
zlib, sRGB-encoded) and .npy. Images may be numpy arrays or tensors on any
device.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_image(path: str, img) -> None:
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if path.endswith(".exr"):
        write_exr(path, img)
    elif path.endswith(".png"):
        write_png(path, img)
    elif path.endswith(".npy"):
        np.save(path, img)
    else:
        raise ValueError(f"unsupported image extension: {path}")


# -- PNG ---------------------------------------------------------------------


def write_png(path: str, img: np.ndarray, gamma: bool = True) -> None:
    """Write [H, W, {1,3}] float (linear, tonemapped via sRGB) or uint8."""
    if img.dtype != np.uint8:
        x = np.clip(np.nan_to_num(np.asarray(img, np.float32)), 0.0, 1.0)
        if gamma:
            x = np.where(
                x <= 0.0031308, x * 12.92, 1.055 * np.power(x, 1 / 2.4) - 0.055
            )
        img = (x * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# -- EXR (uncompressed scanline, float32) ------------------------------------


def _exr_attr(name: bytes, type_: bytes, data: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(data)) + data


def write_exr(path: str, img: np.ndarray) -> None:
    """Write [H, W, {1,3}] float32 as an uncompressed scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"EXR: 1 or 3 channels supported, got {c}")
    channel_names = [b"Y"] if c == 1 else [b"B", b"G", b"R"]  # alphabetical
    # channel list: name\0, int pixel_type(2=float), pLinear+reserved, sampling
    chan = b"".join(
        name + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
        for name in channel_names
    ) + b"\x00"

    header = b""
    header += _exr_attr(b"channels", b"chlist", chan)
    header += _exr_attr(b"compression", b"compression", b"\x00")  # NONE
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0, 0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    offset_table_pos = len(magic) + len(header)
    line_size = 8 + w * 4 * c  # y + size prefix, then pixel data
    offsets = [
        offset_table_pos + 8 * h + i * line_size for i in range(h)
    ]

    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, w * 4 * c))
            if c == 1:
                f.write(np.ascontiguousarray(img[y, :, 0], "<f4").tobytes())
            else:
                # channels stored alphabetically: B, G, R planes per scanline
                f.write(np.ascontiguousarray(img[y, :, 2], "<f4").tobytes())
                f.write(np.ascontiguousarray(img[y, :, 1], "<f4").tobytes())
                f.write(np.ascontiguousarray(img[y, :, 0], "<f4").tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read EXRs written by :func:`write_exr` (uncompressed float32 only)."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack("<i", data[:4])[0] != 20000630:
        raise ValueError(f"{path}: not an EXR")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\x00", pos)
        type_ = data[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack("<i", data[pos:pos + 4])
        pos += 4
        attrs[name] = (type_, data[pos:pos + size])
        pos += size
    pos += 1
    if attrs["compression"][1] != b"\x00":
        raise ValueError(f"{path}: only uncompressed EXRs are read")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    chan_data = attrs["channels"][1]
    channels = []
    cpos = 0
    while chan_data[cpos] != 0:
        cend = chan_data.index(b"\x00", cpos)
        channels.append(chan_data[cpos:cend].decode())
        cpos = cend + 1 + 16
    c = len(channels)
    pos += 8 * h
    img = np.zeros((h, w, c), np.float32)
    for y in range(h):
        pos += 8
        for ci in range(c):
            img[y, :, ci] = np.frombuffer(data[pos:pos + 4 * w], "<f4")
            pos += 4 * w
    if c == 3 and channels == ["B", "G", "R"]:
        img = np.ascontiguousarray(img[..., ::-1])
    return img
