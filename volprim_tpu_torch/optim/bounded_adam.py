"""Bounds-aware Adam (volprim_tpu.optim.bounded_adam).

Per-key learning rates, NaN-gradient zeroing, optional masked updates and
the uniform variant, and bounds: when a step would cross a bound, the
parameter moves half-way to the bound instead and that element's moments
are reset. Where the JAX optimizer is a pure function of (params, grads,
state), this one keeps its state per key (m, v, t) and updates the leaf
tensors of a ``{key: tensor}`` dict in place under ``torch.no_grad()``.
:func:`save_state` / :func:`load_state` write and read the JAX package's
``.npz`` layout (``param/k``, ``m/k``, ``v/k``, ``t/k``), so a checkpoint
resumes in either package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.spans import spanned


@dataclasses.dataclass
class KeyState:
    """Adam moments of one parameter and its step count."""

    m: torch.Tensor
    v: torch.Tensor
    t: int = 0


class BoundedAdam:
    def __init__(
        self,
        lr: float = 1e-3,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        epsilon: float = 1e-8,
        mask_updates: bool = False,
        uniform: bool = False,
    ):
        if not (0 <= beta_1 < 1 and 0 <= beta_2 < 1 and lr > 0 and epsilon > 0):
            raise ValueError("need 0 <= beta_1, beta_2 < 1 and lr, epsilon > 0")
        self.lr_default = lr
        self.lr: Dict[str, float] = {}
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.mask_updates = mask_updates
        self.uniform = uniform
        self.bounds: Dict[str, Tuple[Optional[float], Optional[float]]] = {}
        self.state: Dict[str, KeyState] = {}

    def set_learning_rate(self, lr) -> None:
        """A scalar (the default) or a ``{key: lr}`` dict."""
        if isinstance(lr, dict):
            self.lr.update(lr)
        else:
            self.lr_default = float(lr)

    def set_bounds(self, key: str, lower: float = None, upper: float = None) -> None:
        if lower is not None and upper is not None and not lower < upper:
            raise ValueError(
                f"set_bounds({key!r}): lower ({lower}) must be < upper ({upper})"
            )
        self.bounds[key] = (upper, lower)

    def reset(self, key: str) -> None:
        """Forget a key's moments and step count (when its shape changes);
        the next step starts them again from zero."""
        self.state.pop(key, None)

    @spanned("optim.step")
    @torch.no_grad()
    def step(
        self,
        params: Dict[str, torch.Tensor],
        grads: Optional[Dict[str, torch.Tensor]] = None,
        active: Optional[Dict[str, torch.Tensor]] = None,
    ) -> None:
        """One step on every key of ``params``, in place. Gradients are
        ``grads[k]`` or, without ``grads``, each parameter's ``.grad`` (a
        parameter without one is skipped). ``active[k]`` masks the elements
        that move."""
        active = active or {}
        f32 = torch.float32
        for k, p in params.items():
            g = p.grad if grads is None else grads[k]
            if g is None:
                continue
            g = torch.where(torch.isnan(g), 0.0, g)
            st = self.state.get(k)
            if st is None:
                st = self.state[k] = KeyState(torch.zeros_like(p), torch.zeros_like(p))
            st.t += 1
            # the bias correction in f32, as jnp computes it
            tf = torch.tensor(float(st.t), dtype=f32, device=p.device)
            b1 = torch.tensor(self.beta_1, dtype=f32, device=p.device)
            b2 = torch.tensor(self.beta_2, dtype=f32, device=p.device)
            lr_scale = torch.sqrt(1.0 - b2**tf) / (1.0 - b1**tf)
            lr_t = self.lr.get(k, self.lr_default) * lr_scale

            m_t = self.beta_1 * st.m + (1.0 - self.beta_1) * g
            v_t = self.beta_2 * st.v + (1.0 - self.beta_2) * g * g
            mask = active.get(k)
            if self.mask_updates:
                gm = g != 0.0
                mask = gm if mask is None else (mask & gm)
            if mask is not None:
                m_t = torch.where(mask, m_t, st.m)
                v_t = torch.where(mask, v_t, st.v)

            if self.uniform:
                step = lr_t * m_t / (torch.sqrt(torch.max(v_t)) + self.epsilon)
            else:
                step = lr_t * m_t / (torch.sqrt(v_t) + self.epsilon)
            if mask is not None:
                step = torch.where(mask, step, 0.0)

            v_cur = p
            u = v_cur - step
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
            st.m, st.v = m_t, v_t


def save_state(path: str, params: Dict[str, torch.Tensor], opt: BoundedAdam) -> None:
    """Parameters and moments as an ``.npz`` in the JAX package's layout."""
    payload = {}
    for k, p in params.items():
        st = opt.state.get(k) or KeyState(torch.zeros_like(p), torch.zeros_like(p))
        payload[f"param/{k}"] = p.detach().cpu().numpy()
        payload[f"m/{k}"] = st.m.cpu().numpy()
        payload[f"v/{k}"] = st.v.cpu().numpy()
        payload[f"t/{k}"] = np.asarray(st.t, np.int32)
    np.savez(path, **payload)


def load_state(path: str, opt: BoundedAdam, device=None) -> Dict[str, torch.Tensor]:
    """Read a checkpoint of :func:`save_state` (or of the JAX package's
    ``save_state``): sets ``opt``'s moments and returns the parameters as
    leaf tensors that require grad, on ``device`` (the card unless the
    caller asks for the CPU)."""
    from .. import as_device

    dev = as_device(device)
    data = np.load(path)
    parts: Dict[str, dict] = {"param": {}, "m": {}, "v": {}, "t": {}}
    for full in data.files:
        kind, key = full.split("/", 1)
        parts[kind][key] = data[full]

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    params = {k: t(x).requires_grad_(True) for k, x in parts["param"].items()}
    for k in params:
        opt.state[k] = KeyState(t(parts["m"][k]), t(parts["v"][k]), int(parts["t"][k]))
    return params
