"""What the drivers share. A driver is the file ``portbench/drivers/<entry>.py``
that a traffic file names (its ``"entry"`` key); its class ``Driver`` reads
its sizes from the configuration file and its traffic from the traffic file.

A driver builds its inputs from the seed (``inputs``), hands them to the
program, warms up the shapes of the cell (``setup``), runs the timed window
(``window``) or the traced one (``traced``), counts the traced window's work
from the reference's own shortlists and shapes (``count_work``, run after the
program's peak memory is read), and compares what the program produced with
the plain reference (``check``) once the window has closed; ``control`` puts
the reference, in a lower precision, in the program's place. The program is
``volprim_tpu_torch``, imported by the drivers and nowhere in ``reference``.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch

from .reference import adam as ref_adam
from .reference import scene as ref_scene
from .reference import tiled as ref_tiled
from .reference import tomo as ref_tomo


@contextlib.contextmanager
def bf16_pairs():
    """The lower control: the reference's pair math (the compositor's, the
    tomography integrator's) in bfloat16."""
    saved = ref_tiled.PAIR_DTYPE, ref_tomo.PAIR_DTYPE
    ref_tiled.PAIR_DTYPE = ref_tomo.PAIR_DTYPE = torch.bfloat16
    try:
        yield
    finally:
        ref_tiled.PAIR_DTYPE, ref_tomo.PAIR_DTYPE = saved


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_config(traffic: dict):
    """The traffic's renderer knobs as the program's RFTiledConfig."""
    from volprim_tpu_torch.models import rf_tiled

    return rf_tiled.RFTiledConfig(**{k: tuple(map(tuple, v)) if isinstance(v, list) else v
                                     for k, v in traffic["renderer"].items()})


def program_cameras(specs: list, prefix: str) -> list:
    from volprim_tpu_torch.scene.cameras import CameraSpecs

    return [CameraSpecs(name=f"{prefix}_{i:02d}", width=s["width"], height=s["height"],
                        to_world=s["to_world"], fov=s["fov"]) for i, s in enumerate(specs)]


def program_optimizer(traffic: dict):
    """The program's BoundedAdam at the traffic's rates and bounds."""
    from volprim_tpu_torch.optim import BoundedAdam

    opt = BoundedAdam()
    opt.set_learning_rate(traffic["learning_rates"])
    for k, (lo, hi) in traffic["bounds"].items():
        opt.set_bounds(k, lower=lo, upper=hi)
    return opt


def ref_splats(p: dict, extent: float) -> ref_scene.Scene:
    return ref_scene.Scene(p["centers"], p["scales"], p["quats"],
                           {"opacities": p["opacities"], "sh_coeffs": p["sh_coeffs"]}, extent)


def leaf_gap(prog: dict, ref: dict, keys) -> dict:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf. A leaf the reference leaves at 0 and the program moves reads
    inf."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(norms.values()) if norms else 0.0
    gaps = {}
    for k in keys:
        gap = abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
        den = max(norms[k], med)
        gaps[k] = gap / den if den > 0 else (0.0 if gap == 0 else float("inf"))
    return gaps


def adam_grads(opt_state: dict, beta_1: float) -> dict:
    """Each key's first gradient as the optimizer took it: m / (1 - beta_1)
    after one step (0 where a bound reset the element's moments)."""
    return {k: m / (1.0 - beta_1) for k, m in opt_state.items()}


class Training:
    """What the two training entries share: the compared first steps and
    the closed-loop window."""

    unit = "step"
    metric = "step_ms"  # the end-to-end metric of the window

    def window(self, seconds: float) -> dict:
        losses, n = [], 0
        sync(self.dev)
        t0 = time.perf_counter()
        while True:
            losses.append(self.step(self.compared + n))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.dev)
        wall = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                             for v in losses]))
        print(f"window: {n} steps in {wall:.6f} s", flush=True)
        return dict(metrics={self.metric: wall / n * 1e3}, attempted=n,
                    failed=int((~finite).sum()))

    def setup(self) -> None:
        """The warm-up: the compared steps through the window's own call,
        keeping the losses, the first gradient from the optimizer's state
        and the change after them."""
        before = {k: v.detach().clone() for k, v in self.params.items()}
        self.prog_losses = []
        for i in range(self.compared):
            self.prog_losses.append(float(self.step(i)))
            if i == 0:
                self.prog_grads = {k: v.clone() for k, v in adam_grads(
                    {k: st.m for k, st in self.opt.state.items()}, 0.9).items()}
        self.prog_change = {k: self.params[k].detach() - before[k] for k in before}

    def free(self) -> None:
        del self.params, self.opt
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> tuple:
        """The plain reference's compared steps from the benchmark's
        inputs: (losses, first gradients, change)."""
        params = {k: v.clone().requires_grad_(True) for k, v in self.init.items()}
        opt = ref_adam.BoundedAdam(self.traffic["learning_rates"], self.traffic["bounds"])
        losses, grads = [], None
        for i in range(self.compared):
            losses.append(self.ref_step(params, opt, i))
            if i == 0:
                grads = {k: v.clone() for k, v in
                         adam_grads({k: st[0] for k, st in opt.state.items()}, 0.9).items()}
        return losses, grads, {k: params[k].detach() - self.init[k] for k in params}

    def check(self) -> list:
        self.free()
        return self.compare(*self.reference())

    def control(self) -> list:
        """The numbers of the control: the reference in a lower precision
        (its pair math in bfloat16) put in the program's place, against
        the reference."""
        self.free()
        ref = self.reference()
        with bf16_pairs():
            self.prog_losses, self.prog_grads, self.prog_change = self.reference()
        return self.compare(*ref)

    def compare(self, ref_losses, ref_grads, ref_change) -> list:
        loss_gap = max(abs(p - r) / abs(r) for p, r in zip(self.prog_losses, ref_losses))
        keys = sorted(ref_grads)
        grad = leaf_gap(self.prog_grads, ref_grads, keys)
        norms = {k: float(torch.linalg.vector_norm(ref_grads[k].double())) for k in keys}
        med = statistics.median(norms.values())
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone: left out of the change
        moving = [k for k in keys if norms[k] >= 1e-3 * med]
        change = leaf_gap(self.prog_change, ref_change, moving)
        print("leaves: grad " + ", ".join(f"{k} {v:.3e}" for k, v in grad.items())
              + " | change " + ", ".join(f"{k} {v:.3e}" for k, v in change.items())
              + f" | left out of the change: {sorted(set(keys) - set(moving))}", flush=True)
        print("losses: program " + ", ".join(f"{v:.9g}" for v in self.prog_losses)
              + " | reference " + ", ".join(f"{v:.9g}" for v in ref_losses), flush=True)
        return [("loss_gap", loss_gap), ("grad_gap", max(grad.values())),
                ("change_gap", max(change.values()) if change else 0.0)]
