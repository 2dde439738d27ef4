"""``train.train_step`` of the tiled renderer's fused route in a closed
loop: every camera rendered, L1 against the targets, backward,
BoundedAdam. The traffic's ``learning_rates`` name the trained parameters;
the rest of the scene is the step's base."""

from __future__ import annotations

import torch

from portbench import driving, inputs
from portbench.reference import scene as ref_scene
from portbench.reference import tiled as ref_tiled
from portbench.work import tiled as work_tiled


class Driver(driving.Training):
    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        from volprim_tpu_torch import train
        from volprim_tpu_torch.scene.ellipsoids import EllipsoidScene

        self.dev, self.seed, self.traffic = dev, seed, traffic
        self.compared = traffic["compared_steps"]
        c, film = traffic["cameras"], config["film"]
        self.cam_specs = inputs.ring_cameras(c["count"], film["width"], film["height"],
                                             c["radius"], c["elev"], c["fov"])
        self.extent = float(config["extent"])
        scene = inputs.splat_scene(config["n_splats"], seed, dev)
        op, sh = inputs.perturb_strong(scene["opacities"], scene["sh_coeffs"], seed)
        self.start = dict(scene, opacities=op, sh_coeffs=sh)
        self.init = {k: self.start[k] for k in traffic["learning_rates"]}
        self.rcfg = ref_tiled.config_of(traffic["renderer"])
        with torch.no_grad():  # the targets: the true scene by the plain path
            state = ref_tiled.build_state(driving.ref_splats(scene, self.extent), self.rcfg)
            self.target = torch.cat([
                ref_tiled.render(state, ref_scene.camera_of(s), self.rcfg, 1, 0, False)
                for s in self.cam_specs], dim=1)
        del state
        self.cfg = driving.program_config(traffic)
        self.cams = driving.program_cameras(self.cam_specs, "train")
        s = {k: v.clone() for k, v in self.start.items()}
        self.base = EllipsoidScene(centers=s["centers"], scales=s["scales"], quats=s["quats"],
                                   attrs={"opacities": s["opacities"],
                                          "sh_coeffs": s["sh_coeffs"]}, extent=self.extent)
        self.params = {k: v.clone().requires_grad_(True) for k, v in self.init.items()}
        self.opt = driving.program_optimizer(traffic)
        self._train = train

    def step(self, i: int):
        loss, _, _ = self._train.train_step(self.params, self.opt, self.target, self.cams,
                                            self.cfg, spp=self.traffic["spp"],
                                            seed=self.seed + i, base=self.base,
                                            jitter=self.traffic["jitter"])
        return loss

    def ref_step(self, params: dict, opt, i: int) -> float:
        return ref_tiled.train_step(params, opt, self.target,
                                    [ref_scene.camera_of(s) for s in self.cam_specs], self.rcfg,
                                    self.traffic["spp"], self.seed + i,
                                    driving.ref_splats(self.start, self.extent),
                                    self.traffic["jitter"])

    def traced(self, profile) -> dict:
        n = self.traffic["traced_steps"]
        self.snaps = []

        def run():
            for j in range(n):
                self.snaps.append({k: self.params[k].detach().clone() for k in self.params})
                self.step(self.compared + j)
            return n

        return profile(run)

    def count_work(self, rec: dict) -> None:
        """The traced steps' compositor work, over the reference's own
        shortlists of each step's parameters."""
        calls = []
        with torch.no_grad():
            for j, snap in enumerate(self.snaps):
                state = ref_tiled.build_state(
                    driving.ref_splats(dict(self.start, **snap), self.extent), self.rcfg)
                for i, s in enumerate(self.cam_specs):
                    ref_tiled.render(state, ref_scene.camera_of(s), self.rcfg,
                                     self.traffic["spp"],
                                     (self.seed + self.compared + j) * 131 + i,
                                     self.traffic["jitter"], calls)
        del self.snaps
        rec["work"] = {"fwd3": work_tiled.total(calls, "fwd"),
                       "bwd3": work_tiled.total(calls, "bwd")}
