"""``rf_tiled.render_state`` frame after frame along an orbit, on a state
that ``build_state`` made at set-up: no autograd."""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import driving, inputs
from portbench.reference import scene as ref_scene
from portbench.reference import tiled as ref_tiled
from portbench.work import tiled as work_tiled


class Driver:
    unit = "frame"

    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        from volprim_tpu_torch.models import rf_tiled
        from volprim_tpu_torch.scene.ellipsoids import EllipsoidScene

        self.dev, self.seed, self.traffic = dev, seed, traffic
        c, film = traffic["cameras"], config["film"]
        self.cam_specs = inputs.ring_cameras(c["count"], film["width"], film["height"],
                                             c["radius"], c["elev"], c["fov"])
        self.scene = inputs.splat_scene(config["n_splats"], seed, dev)
        self.extent = float(config["extent"])
        self.cfg = driving.program_config(traffic)
        self.rcfg = ref_tiled.config_of(traffic["renderer"])
        self.cams = driving.program_cameras(self.cam_specs, "orbit")
        s = {k: v.clone() for k, v in self.scene.items()}
        self.prims = EllipsoidScene(centers=s["centers"], scales=s["scales"], quats=s["quats"],
                                    attrs={"opacities": s["opacities"],
                                           "sh_coeffs": s["sh_coeffs"]}, extent=self.extent)
        self._rf = rf_tiled
        # frames kept for the comparison: drawn from the seed among the
        # first 200, and the window's last frame
        rng = np.random.default_rng(seed)
        self.keep = set(int(i) for i in rng.choice(200, traffic["compared_frames"], replace=False))
        self.kept = {}

    def frame(self, i: int):
        return self._rf.render_state(self.state, self.cams[i % len(self.cams)], self.cfg, None,
                                     spp=self.traffic["spp"], seed=self.seed + i,
                                     jitter=self.traffic["jitter"])

    def setup(self) -> None:
        with torch.no_grad():
            self.state = self._rf.build_state(self.prims, self.cfg)
            for i in range(self.traffic["warm_frames"]):
                self.frame(i)
        driving.sync(self.dev)

    def window(self, seconds: float) -> dict:
        times, n = [], 0
        with torch.no_grad():
            driving.sync(self.dev)
            t0 = time.perf_counter()
            while True:
                t = time.perf_counter()
                img = self.frame(n)
                driving.sync(self.dev)
                times.append(time.perf_counter() - t)
                if n in self.keep:
                    self.kept[n] = img
                last = (n, img)
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
        self.kept[last[0]] = last[1]
        finite = [bool(torch.isfinite(v).all()) for v in self.kept.values()]
        ms = sorted(t * 1e3 for t in times)
        p95 = statistics.quantiles(ms, n=100, method="inclusive")[94] if n > 1 else ms[0]
        print(f"window: {n} frames in {wall:.6f} s, median {statistics.median(ms):.4f} ms, "
              f"95th percentile {p95:.4f} ms", flush=True)
        return dict(metrics={"frame_ms": wall / n * 1e3}, attempted=n, failed=finite.count(False))

    def traced(self, profile) -> dict:
        self.n_traced = n = self.traffic["traced_frames"]

        def run():
            with torch.no_grad():
                for i in range(n):
                    img = self.frame(i)
                    if i in self.keep or i == n - 1:
                        self.kept[i] = img
            return n

        return profile(run)

    def count_work(self, rec: dict) -> None:
        """The traced frames' compositor work, over the reference's own
        shortlists."""
        calls = []
        with torch.no_grad():
            state = ref_tiled.build_state(driving.ref_splats(self.scene, self.extent), self.rcfg)
            for i in range(self.n_traced):
                self._ref_frame(state, i, calls)
        rec["work"] = {"fwd3": work_tiled.total(calls, "fwd")}

    def control(self) -> list:
        """The control's number: the reference's frames in a lower
        precision (the compositor's pair math in bfloat16) against the
        reference's, at the frames that the seed draws."""
        self.__dict__.pop("state", None)
        with torch.no_grad():
            state = ref_tiled.build_state(driving.ref_splats(self.scene, self.extent), self.rcfg)
            with driving.bf16_pairs():
                self.kept = {i: self._ref_frame(state, i) for i in sorted(self.keep)}
        return self.check()

    def _ref_frame(self, state, i, counts=None):
        return ref_tiled.render(state, ref_scene.camera_of(self.cam_specs[i % len(self.cams)]),
                                self.rcfg, self.traffic["spp"], self.seed + i,
                                self.traffic["jitter"], counts)

    def check(self) -> list:
        self.__dict__.pop("state", None)
        worst, worst_max = 0.0, 0.0
        with torch.no_grad():
            state = ref_tiled.build_state(driving.ref_splats(self.scene, self.extent), self.rcfg)
            for i, img in sorted(self.kept.items()):
                want = self._ref_frame(state, i)
                diff = (img.float() - want).double()
                rms = float(torch.sqrt(torch.mean(diff * diff)))
                worst = max(worst, rms if np.isfinite(rms) else float("inf"))
                worst_max = max(worst_max, float(diff.abs().max()))
        print(f"frames compared: {sorted(self.kept)}; largest pixel gap {worst_max:.6e}",
              flush=True)
        return [("frame_rms_gap", worst)]
