"""Discrete energy-proportional sampling (volprim_tpu.tooling.energy_pmf).

A distribution over elements weighted by their (clamped) energy, with
``sample`` (inverse-CDF by ``torch.searchsorted``, the left side as
``jnp.searchsorted`` takes it), ``eval_pdf`` and the ``test`` self-check,
which compares empirical frequencies with the pmf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class EnergyPMF:
    pmf: torch.Tensor  # [N]
    cdf: torch.Tensor  # [N] inclusive

    @staticmethod
    def from_energies(energies: torch.Tensor) -> "EnergyPMF":
        e = torch.clamp(energies.reshape(-1), min=0.0)
        total = torch.clamp(torch.sum(e), min=1e-30)
        pmf = e / total
        return EnergyPMF(pmf=pmf, cdf=torch.cumsum(pmf, dim=0))

    def sample(self, generator: Optional[torch.Generator] = None, shape=()) -> torch.Tensor:
        """Element indices of the given shape, drawn from ``generator`` (on
        the pmf's device)."""
        u = torch.rand(shape, generator=generator, device=self.cdf.device, dtype=self.cdf.dtype)
        idx = torch.searchsorted(self.cdf, u.reshape(-1)).reshape(u.shape)
        return torch.clamp(idx, 0, self.pmf.shape[0] - 1)

    def eval_pdf(self, idx: torch.Tensor) -> torch.Tensor:
        return self.pmf[idx]

    def test(self, generator: Optional[torch.Generator] = None, n: int = 200000,
             tol: float = 0.02) -> bool:
        """Whether the empirical frequencies of ``n`` draws lie within
        ``tol`` of the pmf."""
        idx = self.sample(generator, (n,))
        hist = torch.zeros_like(self.pmf).index_add_(
            0, idx, torch.ones(n, dtype=self.pmf.dtype, device=self.pmf.device)) / n
        return bool(torch.max(torch.abs(hist - self.pmf)) < tol)
