"""BoundedAdam of the plain reference: a frozen copy of the port's
optimizer (per-key learning rates, NaN gradients zeroed, the bias
correction in f32, and bounds: a step that would cross a bound moves the
parameter half-way to it and resets that element's moments)."""

from __future__ import annotations

import torch


class BoundedAdam:
    def __init__(self, lrs: dict, bounds: dict, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 lr_default=1e-3):
        self.lrs = dict(lrs)
        self.bounds = {k: (b[1], b[0]) for k, b in bounds.items()}  # key -> (upper, lower)
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon
        self.lr_default = lr_default
        self.state = {}  # key -> [m, v, t]

    @torch.no_grad()
    def step(self, params: dict) -> None:
        f32 = torch.float32
        for k, p in params.items():
            g = p.grad
            if g is None:
                continue
            g = torch.where(torch.isnan(g), 0.0, g)
            st = self.state.setdefault(k, [torch.zeros_like(p), torch.zeros_like(p), 0])
            st[2] += 1
            tf = torch.tensor(float(st[2]), dtype=f32, device=p.device)
            b1 = torch.tensor(self.beta_1, dtype=f32, device=p.device)
            b2 = torch.tensor(self.beta_2, dtype=f32, device=p.device)
            lr_t = self.lrs.get(k, self.lr_default) * (torch.sqrt(1.0 - b2 ** tf) / (1.0 - b1 ** tf))
            m_t = self.beta_1 * st[0] + (1.0 - self.beta_1) * g
            v_t = self.beta_2 * st[1] + (1.0 - self.beta_2) * g * g
            v_cur = p
            u = v_cur - lr_t * m_t / (torch.sqrt(v_t) + self.epsilon)
            if k in self.bounds:
                upper, lower = self.bounds[k]
                over = torch.zeros_like(u, dtype=torch.bool)
                if upper is not None:
                    ob = u >= upper
                    v_cur = torch.where(ob & (v_cur >= upper), upper, v_cur)
                    u = torch.where(ob, v_cur + 0.5 * (upper - v_cur), u)
                    over = ob
                if lower is not None:
                    ob = u <= lower
                    v_cur = torch.where(ob & (v_cur <= lower), lower, v_cur)
                    u = torch.where(ob, v_cur - 0.5 * (v_cur - lower), u)
                    over = over | ob
                m_t = torch.where(over, 0.0, m_t)
                v_t = torch.where(over, 0.0, v_t)
            p.copy_(u)
            st[0], st[1] = m_t, v_t
