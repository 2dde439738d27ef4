"""``examples/optimize_volume.train_step`` in a closed loop: the batch
sensor through the tomography integrator, L1, backward, BoundedAdam."""

from __future__ import annotations

import types

import torch

from portbench import driving, inputs
from portbench.reference import scene as ref_scene
from portbench.reference import tomo as ref_tomo
from portbench.work import tomo as work_tomo


class Driver(driving.Training):
    metric = "fit_step_ms"

    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        from volprim_tpu_torch.examples import optimize_volume
        from volprim_tpu_torch.models import tomography
        from volprim_tpu_torch.ops.envmap import ConstantEmitter

        self.dev, self.seed, self.traffic = dev, seed, traffic
        self.compared = traffic["compared_steps"]
        c = traffic["cameras"]
        self.cam_specs = inputs.tomo_cameras(c["count"], c["res"], seed)
        self.extent = float(config["extent"])
        self.max_depth = int(config["max_depth"])
        lat = inputs.lattice(config["volprim_count"], config["init_sigmat"], config["init_albedo"])
        self.init = {k: torch.from_numpy(v).to(dev) for k, v in lat.items()}
        grid = torch.from_numpy(inputs.smoke_grid(config["grid_res"], seed)).to(dev)
        g = traffic["grid_to_world"]
        scale = torch.tensor(g["scale"], device=dev)
        trans = torch.tensor(g["translate"], device=dev)
        bbox_min, bbox_max = trans, scale + trans
        self.ref_cams = [ref_scene.camera_of(s) for s in self.cam_specs]
        with torch.no_grad():  # the targets: the absorption marcher, clipped
            self.target = torch.clamp(ref_tomo.render_batch(
                ref_tomo.absorption(grid, bbox_min, bbox_max, traffic["ref_sigma_scale"],
                                    traffic["ref_steps"]),
                self.ref_cams, traffic["ref_spp"], ref_tomo.generator(dev, seed), dev), 0.0, 1.0)
        self.cams = driving.program_cameras(self.cam_specs, "cam")
        self.cfg = tomography.TomographyConfig(max_depth=self.max_depth,
                                               kernel_type=config["kernel"],
                                               chunk_size=config["chunk_size"])
        self.emitter = ConstantEmitter(radiance=torch.ones(3, device=dev))
        self.args = types.SimpleNamespace(opt_spp=traffic["opt_spp"], grad_spp=0)
        self.params = {k: v.clone().requires_grad_(True) for k, v in self.init.items()}
        self.opt = driving.program_optimizer(traffic)
        self._ov = optimize_volume

    def step(self, i: int):
        loss, _, _ = self._ov.train_step(self.params, self.opt, self.cams, self.cfg, self.emitter,
                                         self.target, self.args, self.seed + i, self.extent)
        return loss

    def ref_step(self, params: dict, opt, i: int) -> float:
        return ref_tomo.train_step(params, opt, self.ref_cams, self.target,
                                   self.traffic["opt_spp"], self.seed + i, self.max_depth,
                                   self.extent)

    def traced(self, profile) -> dict:
        self.n_traced = n = self.traffic["traced_steps"]

        def run():
            for j in range(n):
                self.step(self.compared + j)
            return n

        return profile(run)

    def count_work(self, rec: dict) -> None:
        """Every ray of the traced steps against every primitive."""
        rays = sum(c["width"] * c["height"] for c in self.cam_specs) * self.traffic["opt_spp"]
        one = work_tomo.step_bound(rays, int(self.init["centers"].shape[0]))
        rec["work"] = {"tomo_step": dict(one, seconds=one["seconds"] * self.n_traced)}
