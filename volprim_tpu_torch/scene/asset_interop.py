"""Reference "Python asset" interop (volprim_tpu.scene.asset_interop):
read and write the importable asset directories of the reference
toolchain.

Such a directory holds an ``__init__.py`` that defines ``OBJECTS`` /
``SENSORS`` / ``EMITTERS`` Mitsuba scene dictionaries (and optionally
``INTEGRATOR``), with bulk data in ``data/*.ply`` / ``data/*.npy``; the
ellipsoid PLY layout is the 3DGS layout scene/ply.py speaks.

- :func:`load_reference_asset` executes the asset's ``__init__.py``
  against small ``mi`` / ``dr`` / ``T`` stand-ins (the header imports are
  stripped at the AST level) and converts the dictionaries into the port's
  objects, on the card unless the caller asks for the CPU.
- :func:`save_reference_asset` writes the same directory structure; its
  ``__init__.py`` is text-identical to the JAX package's for the same
  inputs, so either package reads what the other wrote.
"""

from __future__ import annotations

import os
from os.path import dirname, exists, join
from typing import Optional, Sequence

import numpy as np
import torch

from . import ply as ply_io
from .cameras import CameraSpecs, look_at
from .ellipsoids import EllipsoidScene


# ---------------------------------------------------------------------------
# Stand-ins for the asset header's imports (mi / dr / T)
# ---------------------------------------------------------------------------


def _as_vec3(v):
    a = np.asarray(v, np.float64).reshape(-1)
    return a[:3]


class _Transform:
    """Minimal ScalarTransform4f: matrix ctor, look_at, rotate, chaining."""

    def __init__(self, matrix=None):
        self.matrix = (
            np.eye(4) if matrix is None else np.asarray(matrix, np.float64)
        )

    def look_at(self, origin, target, up):
        m = np.asarray(
            look_at(_as_vec3(origin), _as_vec3(target), _as_vec3(up)),
            np.float64,
        )
        return _Transform(self.matrix @ m)

    def rotate(self, axis, angle):
        axis = _as_vec3(axis)
        axis = axis / np.linalg.norm(axis)
        a = np.radians(float(angle))
        c, s = np.cos(a), np.sin(a)
        x, y, z = axis
        r = np.array(
            [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s, 0],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s, 0],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c), 0],
                [0, 0, 0, 1],
            ]
        )
        return _Transform(self.matrix @ r)

    def scale(self, v):
        v = np.asarray(v, np.float64).reshape(-1)
        if v.size == 1:
            v = np.repeat(v, 3)
        m = np.diag(np.concatenate([v[:3], [1.0]]))
        return _Transform(self.matrix @ m)

    def translate(self, v):
        v = np.asarray(v, np.float64).reshape(-1)
        if v.size == 1:
            v = np.repeat(v, 3)
        m = np.eye(4)
        m[:3, 3] = v[:3]
        return _Transform(self.matrix @ m)

    def __matmul__(self, other):
        if isinstance(other, _Transform):
            return _Transform(self.matrix @ other.matrix)
        return self.matrix @ np.asarray(other)


class _Namespace:
    """Attribute sink: unknown attributes resolve to identity-ish callables
    (covers mi.ScalarPoint3f, dr.FilterMode.*, ...)."""

    def __getattr__(self, name):
        return _NamespaceValue(name)


class _NamespaceValue:
    def __init__(self, name):
        self._name = name

    def __call__(self, *args, **kwargs):
        if len(args) == 1:
            return args[0]
        return args if args else self._name

    def __getattr__(self, name):
        return f"{self._name}.{name}"


def _exec_asset(path: str) -> dict:
    """Execute the asset's __init__.py against the stand-ins; return its
    globals (OBJECTS / SENSORS / EMITTERS / optionally INTEGRATOR).

    The header imports are stripped at the AST level, so multi-line and
    indented imports go too. Imports anywhere but module top level, and
    ``__import__`` calls, raise instead of executing partially.
    """
    import ast

    init = join(path, "__init__.py")
    if not exists(init):
        raise FileNotFoundError(f"invalid asset path: {init}")
    with open(init) as f:
        src = f.read()
    tree = ast.parse(src, filename=init)
    body = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue  # stand-ins replace the header imports
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Import, ast.ImportFrom)):
                raise ValueError(
                    f"{init}:{sub.lineno}: import inside a statement — "
                    "refusing to exec a hand-edited asset the stand-in "
                    "environment cannot satisfy"
                )
            if (
                isinstance(sub, ast.Name) and sub.id == "__import__"
            ):
                raise ValueError(
                    f"{init}:{sub.lineno}: __import__ is not allowed in "
                    "asset files"
                )
        body.append(node)
    tree.body = body
    gl = {
        "os": os,
        "join": join,
        "dirname": dirname,
        "np": np,
        "mi": _Namespace(),
        "dr": _Namespace(),
        "T": _Transform,
        "__file__": init,
    }
    exec(compile(tree, init, "exec"), gl)
    return gl


def _check_no_standin_leaks(tag: str, obj, path: str = "") -> None:
    """Raise if a stand-in object leaked into the parsed dictionaries: the
    sign of an asset using an ``mi.<something>`` the stand-ins cannot
    evaluate."""
    if isinstance(obj, (_Namespace, _NamespaceValue)):
        raise ValueError(
            f"asset {tag}{path}: unresolved Mitsuba construct "
            f"{getattr(obj, '_name', '<namespace>')!r} — the stand-in "
            "environment cannot evaluate it (pass strict=False to ignore)"
        )
    if isinstance(obj, dict):
        for k, v in obj.items():
            _check_no_standin_leaks(tag, v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _check_no_standin_leaks(tag, v, f"{path}[{i}]")


_KNOWN_SENSORS = ("perspective", "orthographic", "thinlens", "batch")
_KNOWN_EMITTERS = ("constant", "envmap", "point")


def _find_first(d: dict, pred):
    for k, v in d.items():
        if isinstance(v, dict) and pred(v):
            return k, v
    return None, None


def load_reference_asset(path: str, extent: float = 3.0, strict: bool = True, device=None):
    """Load a reference Python-asset directory, its tensors on ``device``
    (the card unless the caller asks for the CPU).

    Returns a dict with keys ``primitives`` (EllipsoidScene or None),
    ``cameras`` (list[CameraSpecs]), ``emitter`` (ConstantEmitter,
    EnvironmentMap or None), ``integrator`` (plugin-name string or None)
    and ``raw`` (the executed OBJECTS/SENSORS/EMITTERS dictionaries).

    ``strict`` (default): unknown plugin types and unresolved Mitsuba
    constructs raise ``ValueError`` instead of being skipped; machine-written
    assets always pass, hand-edited ones the stand-ins cannot evaluate fail.
    """
    from .. import as_device

    dev = as_device(device)
    gl = _exec_asset(path)
    objects = gl.get("OBJECTS", {}) or {}
    sensors = gl.get("SENSORS", {}) or {}
    emitters = gl.get("EMITTERS", {}) or {}

    if strict:
        for tag, d in (
            ("OBJECTS", objects), ("SENSORS", sensors), ("EMITTERS", emitters)
        ):
            _check_no_standin_leaks(tag, d)
        for name, sd in sensors.items():
            if isinstance(sd, dict) and sd.get("type") not in _KNOWN_SENSORS:
                raise ValueError(
                    f"asset SENSORS[{name!r}]: unknown sensor type "
                    f"{sd.get('type')!r} (known: {_KNOWN_SENSORS}; pass "
                    "strict=False to skip it)"
                )
        for name, ed in emitters.items():
            if isinstance(ed, dict) and ed.get("type") not in _KNOWN_EMITTERS:
                raise ValueError(
                    f"asset EMITTERS[{name!r}]: unknown emitter type "
                    f"{ed.get('type')!r} (known: {_KNOWN_EMITTERS}; pass "
                    "strict=False to skip it)"
                )

    out = {
        "primitives": None,
        "cameras": [],
        "emitter": None,
        "integrator": None,
        "raw": {
            "objects": objects, "sensors": sensors, "emitters": emitters,
        },
    }

    integ = gl.get("INTEGRATOR")
    if isinstance(integ, dict):
        out["integrator"] = integ.get("type")
        out["raw"]["integrator"] = integ

    _, ell = _find_first(
        objects,
        lambda v: isinstance(v.get("type"), str) and "ellipsoid" in v["type"],
    )
    if ell is not None:
        if "filename" in ell:
            out["primitives"] = ply_io.load_ply(
                join(path, ell["filename"]), extent=extent, device=dev
            )
        elif "centers" in ell:

            def t(v):
                return torch.from_numpy(np.array(v, np.float32)).to(dev)

            attrs = {
                k: t(np.atleast_2d(np.asarray(v, np.float32)))
                for k, v in ell.items()
                if isinstance(v, np.ndarray)
                and k not in ("centers", "scales", "quaternions")
            }
            out["primitives"] = EllipsoidScene(
                centers=t(ell["centers"]), scales=t(ell["scales"]),
                quats=t(ell["quaternions"]), attrs=attrs, extent=extent,
            )

    for name, sd in sensors.items():
        if not isinstance(sd, dict) or sd.get("type") not in (
            "perspective", "orthographic", "thinlens",
        ):
            continue
        film = sd.get("film", {})
        w = int(film.get("width", 768))
        h = int(film.get("height", 576))
        to_world = sd.get("to_world", _Transform())
        mat = (
            to_world.matrix if isinstance(to_world, _Transform)
            else np.asarray(to_world, np.float64)
        )
        out["cameras"].append(
            CameraSpecs(
                name=str(name), width=w, height=h,
                to_world=np.asarray(mat, np.float32),
                fov=float(sd.get("fov", 45.0)),
            )
        )

    for _, ed in emitters.items():
        if not isinstance(ed, dict):
            continue
        if ed.get("type") == "constant":
            from ..ops.envmap import ConstantEmitter

            rad = ed.get("radiance", 1.0)
            if isinstance(rad, dict):
                rad = rad.get("value", 1.0)
            rad = np.asarray(rad, np.float32).reshape(-1)
            if rad.size == 1:
                rad = np.repeat(rad, 3)
            out["emitter"] = ConstantEmitter(radiance=torch.from_numpy(rad).to(dev))
        elif ed.get("type") == "envmap":
            from ..ops.envmap import EnvironmentMap, procedural_sky
            from ..utils.image import read_exr

            fn = ed.get("filename")
            full = join(path, fn) if fn else None
            if full and exists(full):
                out["emitter"] = EnvironmentMap.from_array(read_exr(full), device=dev)
            else:  # a missing texture: the procedural sky stands in
                out["emitter"] = procedural_sky(device=dev)
    return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

_HEADER = """import os
from os.path import join, dirname
import numpy as np
import drjit as dr
import mitsuba as mi
from mitsuba.scalar_rgb import ScalarTransform4f as T

"""


def _fmt_look_at(to_world: np.ndarray, indent: str) -> str:
    m = np.asarray(to_world, np.float64)
    origin = m[:3, 3]
    target = origin + m[:3, 2]
    up = m[:3, 1]
    fmt = lambda v: "[" + ", ".join(f"{x:.9g}" for x in v) + "]"
    return (
        "T().look_at(\n"
        f"{indent}         origin={fmt(origin)},\n"
        f"{indent}         target={fmt(target)},\n"
        f"{indent}         up={fmt(up)},\n"
        f"{indent}     )"
    )


def save_reference_asset(
    path: str,
    primitives: EllipsoidScene,
    cameras: Optional[Sequence[CameraSpecs]] = None,
    emitter=None,
    kernel_type: str = "gaussian",
    shape_type: str = "ellipsoidsmesh",
) -> None:
    """Write a reference-importable Python asset directory:
    ``__init__.py`` + ``data/root.object.ply`` in the ellipsoid PLY layout
    (and ``textures/environment.exr`` for an environment map)."""
    os.makedirs(join(path, "data"), exist_ok=True)
    ply_io.save_ply(primitives, join(path, "data", "root.object.ply"))

    lines = [_HEADER]
    lines.append("OBJECTS = {")
    lines.append(
        "    'resources': { 'type': 'resources', 'path': dirname(__file__) },"
    )
    lines.append("    'object': {")
    lines.append(f"        'type': '{shape_type}',")
    lines.append("        'filename': r'data/root.object.ply',")
    lines.append(f"        'kernel_type': '{kernel_type}',")
    lines.append("    },")
    lines.append("}\n")

    lines.append("SENSORS = {")
    for i, cam in enumerate(cameras or []):
        lines.append(f"    'sensor_{i:04d}': {{")
        lines.append("        'type': 'perspective',")
        lines.append(f"        'fov': {float(cam.fov):.9g},")
        lines.append("        'fov_axis': 'x',")
        lines.append(
            "        'to_world': " + _fmt_look_at(cam.to_world, "    ") + ","
        )
        lines.append("        'film': {")
        lines.append("            'type': 'hdrfilm',")
        lines.append(f"            'width': {cam.width},")
        lines.append(f"            'height': {cam.height},")
        lines.append("        },")
        lines.append("    },")
    lines.append("}\n")

    lines.append("EMITTERS = {")
    if emitter is not None:
        from ..ops.envmap import ConstantEmitter

        if isinstance(emitter, ConstantEmitter):
            rad = emitter.radiance.detach().cpu().numpy().reshape(-1)
            val = (
                f"{float(rad[0]):.9g}" if np.allclose(rad, rad[0])
                else "[" + ", ".join(f"{x:.9g}" for x in rad) + "]"
            )
            lines.append("    'environment': {")
            lines.append("        'type': 'constant',")
            lines.append(
                "        'radiance': { 'type': 'rgb', 'value': %s }," % val
            )
            lines.append("    },")
        else:  # EnvironmentMap -> write the texture alongside
            from ..utils.image import write_image

            os.makedirs(join(path, "textures"), exist_ok=True)
            write_image(
                join(path, "textures", "environment.exr"),
                emitter.data.detach().cpu().numpy(),
            )
            lines.append("    'environment': {")
            lines.append("        'type': 'envmap',")
            lines.append("        'filename': r'textures/environment.exr',")
            lines.append("    },")
    lines.append("}")

    with open(join(path, "__init__.py"), "w") as f:
        f.write("\n".join(lines) + "\n")
