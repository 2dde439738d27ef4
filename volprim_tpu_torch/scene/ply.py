"""3DGS-convention PLY codec for ellipsoid primitives (volprim_tpu.scene.ply).

Fields, as 3DGS writes them:

- ``x, y, z``: centers; ``nx, ny, nz``: zero normals (ignored on read)
- ``scale_0..2``: **log** scales
- ``rot_0..3``: the quaternion as (w, x, y, z); in memory (x, y, z, w),
  normalised on read
- ``opacity``: **logit** opacity (sigmoid on read)
- ``f_dc_0..2`` + ``f_rest_*``: SH coefficients, channel-major in the file,
  basis-major interleaved [N, 3K] in memory
- any other ``name_<i>`` group (e.g. ``sigma_t_0``, ``albedo_0..2``)
  becomes an [N, D] attribute.

Binary files are parsed by the native parser (``volprim_tpu_torch.native``)
when it builds, else by numpy; ASCII files by numpy. The arrays are made in
numpy and moved to the scene's device once.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .ellipsoids import EllipsoidScene

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply_vertex_table(path: str, use_native: bool = True) -> Dict[str, np.ndarray]:
    """A PLY file's 'vertex' element as {property name: column}."""
    if use_native:
        from .. import native

        cols = native.parse_ply_columns(path)
        if cols is not None:
            return cols
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    if header[0].strip() != "ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt = count = None
    props = []
    in_vertex = False
    for line in header[1:]:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError(f"{path}: list properties are not supported for vertices")
            props.append((parts[-1], _PLY_DTYPES[parts[1]]))
    if count is None:
        raise ValueError(f"{path}: no vertex element")
    if fmt == "binary_little_endian":
        dtype = np.dtype(props)
        table = np.frombuffer(data[end:end + dtype.itemsize * count], dtype=dtype)
        return {n: np.ascontiguousarray(table[n]) for n, _ in props}
    if fmt == "ascii":
        rows = np.loadtxt(data[end:].decode("ascii").splitlines(), dtype=np.float64,
                          ndmin=2)[:count]
        return {n: rows[:, i].astype(np.dtype(t)) for i, (n, t) in enumerate(props)}
    raise ValueError(f"{path}: unsupported PLY format {fmt}")


def _sh_from_ply(f_dc: np.ndarray, f_rest: np.ndarray) -> np.ndarray:
    """(f_dc [N, 3], f_rest [N, 3(K-1)] channel-major) -> [N, 3K]
    basis-major interleaved."""
    n = f_dc.shape[0]
    k_rest = f_rest.shape[1] // 3
    sh = np.zeros((n, k_rest + 1, 3), np.float32)
    sh[:, 0, :] = f_dc
    for j in range(1, k_rest + 1):
        for ch in range(3):
            sh[:, j, ch] = f_rest[:, ch * k_rest + (j - 1)]
    return sh.reshape(n, 3 * (k_rest + 1))


def _sh_to_ply(sh_coeffs: np.ndarray):
    """[N, 3K] basis-major interleaved -> (f_dc, f_rest channel-major)."""
    n = sh_coeffs.shape[0]
    sh = sh_coeffs.reshape(n, -1, 3)
    k = sh.shape[1]
    f_rest = np.zeros((n, 3 * (k - 1)), np.float32)
    for j in range(1, k):
        for ch in range(3):
            f_rest[:, ch * (k - 1) + (j - 1)] = sh[:, j, ch]
    return sh[:, 0, :], f_rest


def load_ply(path: str, extent: float = 3.0, device=None,
             use_native: bool = True) -> EllipsoidScene:
    """A 3DGS-convention ellipsoids PLY as an EllipsoidScene on ``device``
    (the card unless the caller asks for the CPU)."""
    from .. import as_device

    dev = as_device(device)
    cols = read_ply_vertex_table(path, use_native)
    centers = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
    scales = np.exp(
        np.stack([cols["scale_0"], cols["scale_1"], cols["scale_2"]], axis=-1)
    ).astype(np.float32)
    quats = np.stack(
        [cols["rot_1"], cols["rot_2"], cols["rot_3"], cols["rot_0"]], axis=-1
    ).astype(np.float32)
    quats /= np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    consumed = {"x", "y", "z", "nx", "ny", "nz", "scale_0", "scale_1", "scale_2",
                "rot_0", "rot_1", "rot_2", "rot_3"}
    attrs: Dict[str, np.ndarray] = {}
    if "opacity" in cols:
        logit = cols["opacity"].astype(np.float32)
        attrs["opacities"] = (1.0 / (1.0 + np.exp(-logit)))[:, None]
        consumed.add("opacity")
    if "f_dc_0" in cols:
        f_dc = np.stack([cols["f_dc_0"], cols["f_dc_1"], cols["f_dc_2"]],
                        axis=-1).astype(np.float32)
        rest_names = sorted((n for n in cols if n.startswith("f_rest_")),
                            key=lambda n: int(n.split("_")[-1]))
        f_rest = (np.stack([cols[n] for n in rest_names], axis=-1).astype(np.float32)
                  if rest_names else np.zeros((f_dc.shape[0], 0), np.float32))
        attrs["sh_coeffs"] = _sh_from_ply(f_dc, f_rest)
        consumed |= {"f_dc_0", "f_dc_1", "f_dc_2", *rest_names}
    groups: Dict[str, Dict[int, np.ndarray]] = {}
    for name, col in cols.items():
        if name in consumed:
            continue
        m = re.fullmatch(r"(.+)_(\d+)", name)
        if m:
            groups.setdefault(m.group(1), {})[int(m.group(2))] = col
        else:
            groups.setdefault(name, {})[0] = col
    for gname, members in groups.items():
        attrs[gname] = np.stack([members[i] for i in sorted(members)],
                                axis=-1).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    return EllipsoidScene(centers=t(centers), scales=t(scales), quats=t(quats),
                          attrs={k: t(v) for k, v in attrs.items()}, extent=extent)


def save_ply(scene: EllipsoidScene, path: str) -> None:
    """Write an EllipsoidScene to a 3DGS-convention binary PLY."""

    def n_(x):
        return x.detach().cpu().numpy().astype(np.float32) if torch.is_tensor(x) else \
            np.asarray(x, np.float32)

    centers = n_(scene.centers)
    n = centers.shape[0]
    scales = np.log(np.maximum(n_(scene.scales), 1e-6))
    quats = n_(scene.quats)[:, [3, 0, 1, 2]]  # (x, y, z, w) -> (w, x, y, z)
    names = ["x", "y", "z", "nx", "ny", "nz"]
    columns = [centers, np.zeros_like(centers)]
    attrs = {k: n_(v) for k, v in scene.attrs.items()}
    if "sh_coeffs" in attrs and "opacities" in attrs:
        f_dc, f_rest = _sh_to_ply(attrs.pop("sh_coeffs"))
        names += ["f_dc_0", "f_dc_1", "f_dc_2"]
        names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        columns += [f_dc, f_rest]
        op = np.clip(attrs.pop("opacities"), 1e-8, 1.0 - 1e-8)
        names += ["opacity"]
        columns += [np.log(op) - np.log(1.0 - op)]  # logit
    for k in sorted(attrs):
        v = attrs[k].reshape(n, -1)
        names += [f"{k}_{i}" for i in range(v.shape[1])]
        columns += [v]
    names += ["scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    columns += [scales, quats]
    table = np.concatenate([c.reshape(n, -1).astype("<f4") for c in columns], axis=1)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(table).tobytes())
