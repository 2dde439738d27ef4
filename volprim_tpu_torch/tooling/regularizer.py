"""Total-variation regularizer over attribute graphs
(volprim_tpu.tooling.regularizer).

The mean absolute difference of vertex attributes across the edges of a
graph: the unique edges of a triangle list, or a k-nearest-neighbour graph
of a point or primitive cloud. The edge lists are built in numpy, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges [E, 2] from a triangle list [F, 3]."""
    faces = np.asarray(faces)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def knn_edges(points: np.ndarray, k: int = 4) -> np.ndarray:
    """k-nearest-neighbour edges for a point cloud [N, 3] (numpy, O(N^2):
    scene-scale preprocessing, not an inner loop)."""
    points = np.asarray(points)
    n = points.shape[0]
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbrs = np.argpartition(d2, k, axis=1)[:, :k]
    e = np.stack([np.repeat(np.arange(n), k), nbrs.reshape(-1)], axis=1)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


class TVRegularizer:
    """Mean |attribute difference| across edges."""

    def __init__(self, edges: np.ndarray, device=None):
        from .. import as_device

        self.edges = torch.as_tensor(np.asarray(edges, np.int64), device=as_device(device))

    def compute_loss(self, attr: torch.Tensor) -> torch.Tensor:
        """attr [N, D] (or [N]) -> scalar TV loss."""
        a = attr[self.edges[:, 0]]
        b = attr[self.edges[:, 1]]
        return torch.mean(torch.abs(a - b))
