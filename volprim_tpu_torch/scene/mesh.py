"""Triangle-mesh surfaces with chunked ray intersection
(volprim_tpu.scene.mesh).

An indexed triangle mesh with per-vertex attributes (normals, BSDF
parameters), intersected by a masked Möller–Trumbore sweep over chunks of
faces: the scenes it serves (a Cornell box, a few spheres) have tens to
hundreds of triangles, for which an [R, F] sweep needs no BVH. Attributes
are interpolated barycentrically at hits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class TriangleMesh:
    """Indexed triangle mesh with per-vertex attributes."""

    vertices: torch.Tensor  # [V, 3] float32
    faces: torch.Tensor  # [F, 3] int64
    attrs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def corners(self):
        """Returns (p0, p1, p2), each [F, 3]."""
        v, f = self.vertices, self.faces
        return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    def face_normals(self) -> torch.Tensor:
        p0, p1, p2 = self.corners()
        n = torch.linalg.cross(p1 - p0, p2 - p0)
        return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)

    def face_areas(self) -> torch.Tensor:
        p0, p1, p2 = self.corners()
        return 0.5 * torch.linalg.norm(torch.linalg.cross(p1 - p0, p2 - p0), dim=-1)

    def vertex_normals(self) -> torch.Tensor:
        """Area-weighted vertex normals [V, 3]."""
        p0, p1, p2 = self.corners()
        fn = torch.linalg.cross(p1 - p0, p2 - p0)  # area-weighted
        vn = torch.zeros_like(self.vertices)
        for k in range(3):
            vn = vn.index_add(0, self.faces[:, k], fn)
        return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True), min=1e-12)

    def interpolate(self, name: str, fid: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
        """Barycentric interpolation of a vertex attribute at hits: fid [R]
        face ids, bary [R, 2] = (u, v), w = 1 - u - v on vertex 0. Returns
        [R, k] (an attribute stored as [V] gives [R, 1])."""
        a = self.attrs[name]
        if a.dim() == 1:
            a = a[:, None]
        f = self.faces[fid]
        w = torch.stack([1.0 - bary[:, 0] - bary[:, 1], bary[:, 0], bary[:, 1]], dim=-1)
        return a[f[:, 0]] * w[:, 0:1] + a[f[:, 1]] * w[:, 1:2] + a[f[:, 2]] * w[:, 2:3]


def merge(meshes) -> TriangleMesh:
    """Concatenate meshes (their attribute keys must agree)."""
    keys = set(meshes[0].attrs)
    off = 0
    vs, fs = [], []
    attrs = {k: [] for k in keys}
    for m in meshes:
        if set(m.attrs) != keys:
            raise ValueError("attribute keys differ")
        vs.append(m.vertices)
        fs.append(m.faces + off)
        off += m.num_vertices
        for k in keys:
            attrs[k].append(m.attrs[k])
    return TriangleMesh(torch.cat(vs), torch.cat(fs), {k: torch.cat(v) for k, v in attrs.items()})


_EPS = 1e-7


def _chunks(mesh: TriangleMesh, chunk: int):
    """(start, e1, e2, p0) per chunk of at most ``chunk`` faces."""
    p0, p1, p2 = mesh.corners()
    for s in range(0, mesh.num_faces, chunk):
        sl = slice(s, s + chunk)
        yield s, (p1 - p0)[sl], (p2 - p0)[sl], p0[sl]


def _moller_trumbore(o, d, e1, e2, p0):
    """Möller–Trumbore for rays [R, 3] x faces [C, 3]: (ok-before-range
    [R, C], t, u, v)."""
    h = torch.linalg.cross(d[:, None, :].expand(-1, e2.shape[0], -1),
                           e2[None].expand(d.shape[0], -1, -1))
    det = torch.sum(e1[None] * h, dim=-1)
    inv = torch.where(torch.abs(det) > _EPS, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    s = o[:, None, :] - p0[None]
    u = torch.sum(s * h, dim=-1) * inv
    q = torch.linalg.cross(s, e1[None].expand_as(s))
    v = torch.sum(d[:, None, :] * q, dim=-1) * inv
    t = torch.sum(e2[None] * q, dim=-1) * inv
    ok = (torch.abs(det) > _EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return ok, t, u, v


def intersect(
    mesh: Optional[TriangleMesh],
    o: torch.Tensor,
    d: torch.Tensor,
    t_min: float = 1e-4,
    t_max=float("inf"),
    chunk: int = 512,
):
    """Nearest hit of rays o, d [R, 3] over all faces, ``chunk`` faces at a
    time. Returns (valid [R], t [R] (inf on a miss), fid [R], bary [R, 2]).
    Among equal distances the lowest face id wins."""
    r = o.shape[0]
    dev = o.device
    best_t = torch.full((r,), torch.inf, dtype=o.dtype, device=dev)
    best_fid = torch.zeros((r,), dtype=torch.int64, device=dev)
    best_uv = torch.zeros((r, 2), dtype=o.dtype, device=dev)
    if mesh is None or mesh.num_faces == 0:
        return torch.zeros((r,), dtype=torch.bool, device=dev), best_t, best_fid, best_uv
    rows = torch.arange(r, device=dev)
    for start, e1, e2, p0 in _chunks(mesh, chunk):
        ok, t, u, v = _moller_trumbore(o, d, e1, e2, p0)
        tt = torch.where(ok & (t > t_min), t, torch.inf)
        j = torch.argmin(tt, dim=1)  # the first of equal minima
        t_c = tt[rows, j]
        closer = t_c < best_t
        best_t = torch.where(closer, t_c, best_t)
        best_fid = torch.where(closer, start + j, best_fid)
        best_uv = torch.where(closer[:, None], torch.stack([u[rows, j], v[rows, j]], dim=-1),
                              best_uv)
    valid = torch.isfinite(best_t) & (best_t < t_max)
    return valid, best_t, best_fid, best_uv


def occluded(
    mesh: Optional[TriangleMesh],
    o: torch.Tensor,
    d: torch.Tensor,
    t_max=float("inf"),
    t_min: float = 1e-4,
    chunk: int = 512,
) -> torch.Tensor:
    """Shadow-ray test: whether any face is hit at t in (t_min, t_max)."""
    any_hit = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    if mesh is None or mesh.num_faces == 0:
        return any_hit
    for _, e1, e2, p0 in _chunks(mesh, chunk):
        ok, t, _, _ = _moller_trumbore(o, d, e1, e2, p0)
        any_hit = any_hit | torch.any(ok & (t > t_min) & (t < t_max), dim=1)
    return any_hit


def sample_surface(mesh: TriangleMesh, generator: torch.Generator, n: int):
    """Area-weighted uniform surface samples: a face drawn in proportion to
    its area, then a uniform point on it, from ``generator`` (n faces, then
    [n, 2] uniforms). Returns (points [n, 3], shading normals [n, 3],
    fid [n], bary [n, 2], pdf [n] = 1 / total area)."""
    dev = mesh.device
    areas = mesh.face_areas()
    total = torch.sum(areas)
    fid = torch.multinomial(torch.clamp(areas, min=1e-20), n, replacement=True,
                            generator=generator)
    uv = torch.rand((n, 2), generator=generator, device=dev, dtype=mesh.vertices.dtype)
    su = torch.sqrt(uv[:, 0])
    bary = torch.stack([su * (1.0 - uv[:, 1]), su * uv[:, 1]], dim=-1)
    p0, p1, p2 = mesh.corners()
    pts = (p0[fid] * (1.0 - bary[:, 0] - bary[:, 1])[:, None] + p1[fid] * bary[:, 0:1]
           + p2[fid] * bary[:, 1:2])
    tmp = TriangleMesh(mesh.vertices, mesh.faces, {"n": mesh.vertex_normals()})
    normals = tmp.interpolate("n", fid, bary)
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12)
    pdf = torch.ones((n,), dtype=pts.dtype, device=dev) / total
    return pts, normals, fid, bary, pdf


# ---------------------------------------------------------------------------
# Builders (geometry in numpy, then on ``device``: the card unless the
# caller asks for the CPU)
# ---------------------------------------------------------------------------


def _mesh(verts, faces, attrs, device) -> TriangleMesh:
    from .. import as_device

    dev = as_device(device)
    nv = verts.shape[0]
    a = {k: torch.from_numpy(np.tile(np.asarray(val, np.float32), (nv, 1))).to(dev)
         for k, val in (attrs or {}).items()}
    return TriangleMesh(torch.from_numpy(np.asarray(verts, np.float32)).to(dev),
                        torch.from_numpy(np.asarray(faces, np.int64)).to(dev), a)


def make_rect(center, u_axis, v_axis, attrs=None, device=None) -> TriangleMesh:
    """Two-triangle rectangle: center +- u_axis +- v_axis."""
    c = np.asarray(center, np.float32)
    u = np.asarray(u_axis, np.float32)
    v = np.asarray(v_axis, np.float32)
    verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    return _mesh(verts, [[0, 1, 2], [0, 2, 3]], attrs, device)


def make_icosphere(center, radius: float, subdiv: int = 2, attrs=None,
                   device=None) -> TriangleMesh:
    """A subdivided icosahedron."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = np.asarray(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t], [0, -1, -t],
         [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.asarray(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        mid = {}
        new_faces = []
        verts = list(map(np.asarray, verts))

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                verts.append(m)
                mid[key] = len(verts) - 1
            return mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = np.asarray(new_faces, np.int64)
        verts = np.stack(verts)
    verts = verts * radius + np.asarray(center, np.float64)
    return _mesh(verts.astype(np.float32), faces, attrs, device)


def cornell_box(size: float = 1.0, attrs_by_wall=None, device=None) -> TriangleMesh:
    """An open Cornell-like box (floor, ceiling, back, red left and green
    right walls) with inward-facing normals."""
    s = size
    default = {
        "floor": {"base_color": [0.73, 0.73, 0.73]},
        "ceiling": {"base_color": [0.73, 0.73, 0.73]},
        "back": {"base_color": [0.73, 0.73, 0.73]},
        "left": {"base_color": [0.65, 0.05, 0.05]},
        "right": {"base_color": [0.12, 0.45, 0.15]},
    }
    spec = attrs_by_wall or default
    # the rectangle's normal is u x v: every wall's points into the box
    walls = {
        "floor": ([0, -s, 0], [0, 0, s], [s, 0, 0]),
        "ceiling": ([0, s, 0], [s, 0, 0], [0, 0, s]),
        "back": ([0, 0, s], [0, s, 0], [s, 0, 0]),
        "left": ([-s, 0, 0], [0, s, 0], [0, 0, s]),
        "right": ([s, 0, 0], [0, 0, s], [0, s, 0]),
    }
    return merge([make_rect(c, u, v, attrs=spec[name], device=device)
                  for name, (c, u, v) in walls.items() if name in spec])
