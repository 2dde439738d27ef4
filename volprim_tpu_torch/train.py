"""Training step through the tiled renderer.

The counterpart of the tiled training loop of the JAX package's
``examples/refine_3dg_dataset.py`` (and of the train step ``bench.py``
times): rebuild the render state from the parameters, render every camera
through the fused compositor (whose backward is a CUDA kernel on the
card), take the L1 loss against the reference image, backpropagate and
step a :class:`BoundedAdam` with per-key learning rates and bounded
opacities::

    params = interop.params_from_jax({"opacities": ..., "sh_coeffs": ...,
                                      "centers": ...}, device="cuda")
    opt = make_optimizer()
    for it in range(iterations):
        loss, psnr, img = train_step(params, opt, ref, cameras, cfg,
                                     seed=it, base=scene)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .models import rf_tiled
from .optim import BoundedAdam, l1, psnr
from .parallel.mesh import Mesh, sum_grads
from .scene.cameras import CameraSpecs
from .scene.ellipsoids import EllipsoidScene
from .utils.spans import span, spanned

OPACITY_BOUNDS = (1e-6, 1.0 - 1e-6)


def make_optimizer(
    opacities_lr: float = 0.05,
    sh_lr: float = 0.01,
    centers_lr: float = 0.0,
    global_lr: float = 1.0,
) -> BoundedAdam:
    """BoundedAdam with the refine example's per-key learning rates (its
    CLI defaults) and opacities bounded to [1e-6, 1 - 1e-6]."""
    opt = BoundedAdam()
    opt.set_learning_rate(
        {
            "opacities": global_lr * opacities_lr,
            "sh_coeffs": global_lr * sh_lr,
            "centers": global_lr * centers_lr,
        }
    )
    opt.set_bounds("opacities", lower=OPACITY_BOUNDS[0], upper=OPACITY_BOUNDS[1])
    return opt


def to_scene(params: Dict[str, torch.Tensor], base: Optional[EllipsoidScene]) -> EllipsoidScene:
    """The scene of ``params`` (any of centers, scales, quats, opacities,
    sh_coeffs), with what they leave out taken from ``base``."""

    def pick(key, fallback):
        if key in params:
            return params[key]
        if base is None:
            raise KeyError(f"{key!r} is neither a parameter nor given by a base scene")
        return fallback()

    attrs = dict(base.attrs) if base is not None else {}
    attrs["opacities"] = pick("opacities", lambda: base.attrs["opacities"])
    attrs["sh_coeffs"] = pick("sh_coeffs", lambda: base.attrs["sh_coeffs"])
    return EllipsoidScene(
        centers=pick("centers", lambda: base.centers),
        scales=pick("scales", lambda: base.scales),
        quats=pick("quats", lambda: base.quats),
        attrs=attrs,
        extent=base.extent if base is not None else 3.0,
    )


def render_cameras(scene: EllipsoidScene, cameras: Sequence[CameraSpecs],
                   cfg: rf_tiled.RFTiledConfig, spp: int = 1, seed: int = 0,
                   jitter: bool = True, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every camera's frame side by side, [H, N*W, 3]; camera i renders
    with seed ``seed * 131 + i``. ``mesh`` shards each frame's tiles over
    its ranks (``rf_tiled.render_state``)."""
    state = rf_tiled.build_state(scene, cfg)
    return torch.cat(
        [
            rf_tiled.render_state(
                state, cam, cfg, None, spp=spp, seed=seed * 131 + i, jitter=jitter,
                mesh=mesh,
            )
            for i, cam in enumerate(cameras)
        ],
        dim=1,
    )


@spanned("train.step")
def train_step(
    params: Dict[str, torch.Tensor],
    opt: BoundedAdam,
    ref_image: torch.Tensor,
    cameras: Sequence[CameraSpecs],
    cfg: rf_tiled.RFTiledConfig,
    spp: int = 1,
    seed: int = 0,
    base: Optional[EllipsoidScene] = None,
    jitter: bool = True,
    mesh: Optional[Mesh] = None,
):
    """One optimizer step on ``params`` (leaf tensors that require grad),
    in place. Returns (L1 loss, PSNR, image), detached, from the render
    before the step. With ``mesh`` every rank renders its block of each
    frame's tiles and the gradients are summed over the ranks before the
    step (``parallel.sum_grads``, as ``parallel.sharded_grad_step`` sums
    them), so replicas that start equal stay equal."""
    for p in params.values():
        p.grad = None
    img = render_cameras(to_scene(params, base), cameras, cfg, spp, seed, jitter, mesh)
    loss = l1(ref_image, img)
    with span("autograd.backward"):
        loss.backward()
    if mesh is not None:
        for p in params.values():
            if p.grad is None:  # every rank sums the same tensors
                p.grad = torch.zeros_like(p)
        sum_grads(mesh, [p.grad for p in params.values()])
    img = img.detach()
    opt.step(params)
    return loss.detach(), psnr(ref_image, img), img
