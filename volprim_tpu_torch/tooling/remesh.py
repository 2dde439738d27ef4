"""Mesh resolution adjustment: midpoint subdivision, short-edge collapse
and tangential relaxation toward a target edge length
(volprim_tpu.tooling.remesh).

- :func:`subdivide`: one conforming midpoint (1-to-4) subdivision, vertex
  attributes interpolated.
- :func:`collapse_short_edges`: contract edges below a threshold
  (midpoint placement, attribute averaging), dropping degenerate faces.
- :func:`tangential_smooth`: Laplacian smoothing projected to the vertex
  tangent plane (area-uniform), the Botsch-Kobbelt relaxation step.
- :func:`remesh_to_target`: iterate split-long / collapse-short / smooth
  until the median edge length approaches the target.

The arithmetic is the JAX package's numpy in f64, unchanged; between steps
the mesh is held in f32, as there. Every function takes and returns a
:class:`volprim_tpu_torch.scene.mesh.TriangleMesh` on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.mesh import TriangleMesh


def _np(x: torch.Tensor, dtype) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy(), dtype)


def _np_mesh(mesh: TriangleMesh):
    v = _np(mesh.vertices, np.float64)
    f = _np(mesh.faces, np.int64)
    attrs = {k: _np(a, np.float64) for k, a in mesh.attrs.items()}
    return v, f, attrs


def _to_mesh(v, f, attrs, device) -> TriangleMesh:
    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    return TriangleMesh(t(v, np.float32), t(f, np.int64),
                        {k: t(a, np.float32) for k, a in attrs.items()})


def edge_lengths(mesh: TriangleMesh) -> np.ndarray:
    """Unique-edge lengths [E]."""
    v, f, _ = _np_mesh(mesh)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    return np.linalg.norm(v[e[:, 0]] - v[e[:, 1]], axis=1)


def subdivide(mesh: TriangleMesh) -> TriangleMesh:
    """Conforming midpoint subdivision: every face -> 4, attributes
    averaged onto edge midpoints."""
    v, f, attrs = _np_mesh(mesh)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e_sorted = np.sort(e, axis=1)
    uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    mid = 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])
    base = v.shape[0]
    v2 = np.concatenate([v, mid])
    m01 = base + inv[: len(f)]
    m12 = base + inv[len(f): 2 * len(f)]
    m20 = base + inv[2 * len(f):]
    f2 = np.concatenate(
        [
            np.stack([f[:, 0], m01, m20], axis=1),
            np.stack([f[:, 1], m12, m01], axis=1),
            np.stack([f[:, 2], m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ]
    )
    attrs2 = {
        k: np.concatenate([a, 0.5 * (a[uniq[:, 0]] + a[uniq[:, 1]])])
        for k, a in attrs.items()
    }
    return _to_mesh(v2, f2, attrs2, mesh.device)


def collapse_short_edges(
    mesh: TriangleMesh, min_len: float
) -> TriangleMesh:
    """Contract edges shorter than ``min_len`` (one disjoint matching per
    call: each vertex participates in at most one collapse), remove the
    resulting degenerate faces."""
    v, f, attrs = _np_mesh(mesh)
    e = np.unique(
        np.sort(
            np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]),
            axis=1,
        ),
        axis=0,
    )
    ln = np.linalg.norm(v[e[:, 0]] - v[e[:, 1]], axis=1)
    order = np.argsort(ln)
    used = np.zeros(v.shape[0], bool)
    remap = np.arange(v.shape[0])
    for i in order:
        if ln[i] >= min_len:
            break
        a, b = e[i]
        if used[a] or used[b]:
            continue
        used[a] = used[b] = True
        v[a] = 0.5 * (v[a] + v[b])
        for arr in attrs.values():
            arr[a] = 0.5 * (arr[a] + arr[b])
        remap[b] = a
    f = remap[f]
    keep = (
        (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 2] != f[:, 0])
    )
    f = f[keep]
    # compact unused vertices
    live = np.zeros(v.shape[0], bool)
    live[f.reshape(-1)] = True
    new_id = np.cumsum(live) - 1
    return _to_mesh(
        v[live], new_id[f], {k: a[live] for k, a in attrs.items()}, mesh.device
    )


def tangential_smooth(
    mesh: TriangleMesh, lam: float = 0.5, iters: int = 1
) -> TriangleMesh:
    """Uniform Laplacian relaxation projected onto vertex tangent planes
    (keeps the surface; the Botsch-Kobbelt relaxation step). Attributes
    are left untouched (they live on the same vertices)."""
    v, f, attrs = _np_mesh(mesh)
    n_v = v.shape[0]
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    for _ in range(iters):
        acc = np.zeros_like(v)
        cnt = np.zeros(n_v)
        np.add.at(acc, e[:, 0], v[e[:, 1]])
        np.add.at(acc, e[:, 1], v[e[:, 0]])
        np.add.at(cnt, e[:, 0], 1)
        np.add.at(cnt, e[:, 1], 1)
        centroid = acc / np.maximum(cnt, 1)[:, None]
        delta = centroid - v
        # vertex normals (area-weighted)
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, f[:, k], fn)
        vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
        delta -= vn * np.sum(delta * vn, axis=1, keepdims=True)
        v = v + lam * delta
    return _to_mesh(v, f, attrs, mesh.device)


def remesh_to_target(
    mesh: TriangleMesh,
    target_len: float,
    max_iters: int = 5,
    smooth_lam: float = 0.4,
) -> TriangleMesh:
    """Bring the mesh's edge lengths toward ``target_len`` (split long
    edges, collapse short ones, relax). Stops early once the median edge is
    within [0.5, 1.4] x target."""
    out = mesh
    for _ in range(max_iters):
        ln = edge_lengths(out)
        med = float(np.median(ln))
        if med > 1.4 * target_len:
            out = subdivide(out)
        elif med < 0.5 * target_len:
            out = collapse_short_edges(out, 0.8 * target_len)
        else:
            break
        out = tangential_smooth(out, lam=smooth_lam, iters=1)
    # final cleanup of any remaining too-short edges
    if float(np.min(edge_lengths(out))) < 0.3 * target_len:
        out = collapse_short_edges(out, 0.5 * target_len)
    return out
