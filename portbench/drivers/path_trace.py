"""``models.render`` of the plume with ``prb.radiance``, as the port's
``examples/render_volume.py`` calls it: closed-loop progressive passes of
one fixed camera, each frame one ``render(..., spp)`` under
``torch.no_grad()``, the generator running on from frame to frame.

The comparison keeps the generator's state before each compared frame (the
window's first and its last, or the traced frame) and the program's
developed pixels at the chosen pixels: the central block and pixels drawn
from the seed. The reference replays the frame's draws from that state (per
pass the film jitter, then the render key, as ``models.render`` and
``prb.radiance`` draw them), traces every sample that lands in a chosen
pixel and develops those pixels. ``frame_rms_gap`` is the RMS of (program
- reference) over the RMS of the reference, over all the chosen pixels, so
it bounds how far the pixels that parted moved; ``flip_share`` is the
share of them that differ by more than ``FLIP`` relative, where a path
parted from the reference's on a rounding-level decision.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import driving, plume
from portbench.reference import pt as ref_pt
from portbench.reference import scene as ref_scene
from portbench.work import pt as work_pt

# a pixel "flips" when its largest channel gap exceeds this share of the
# reference's largest channel: on the card f32 rounding moves a pixel whose
# paths all agree by at most 4e-6 of itself, and a path that parts and
# rejoins (a solver step taken the other way) by some 1e-4; a path that
# takes another turn moves it by a share of a sample's radiance.
FLIP = 1e-3


class Driver:
    unit = "frame"

    def __init__(self, config: dict, traffic: dict, seed: int, dev):
        from volprim_tpu_torch import models
        from volprim_tpu_torch.models import prb
        from volprim_tpu_torch.ops.envmap import EnvironmentMap
        from volprim_tpu_torch.scene.ellipsoids import EllipsoidScene

        if not hasattr(prb, "radiance_keyed"):
            raise RuntimeError("the comparison replays the path tracer's per-ray random streams "
                               "(prb.radiance_keyed), which this program does not have")
        ref_pt.supported(config["integrator"])
        self.dev, self.seed, self.config, self.traffic = dev, seed, config, traffic
        self.w, self.h = config["film"]["width"], config["film"]["height"]
        self.spp = config["spp"]
        self.arrays = plume.plume(config["n_prims"], seed, config["sigmat_scale"])
        self.sky = plume.sky(config["sky"]["height"], config["sky"]["width"])
        self.cam = plume.camera(self.w, self.h)
        t = {k: torch.from_numpy(v).to(dev) for k, v in self.arrays.items()}
        self.scene = EllipsoidScene(centers=t["centers"], scales=t["scales"], quats=t["quats"],
                                    attrs={"sigma_t": t["sigma_t"], "albedo": t["albedo"]},
                                    extent=float(config["extent"]))
        self.emitter = EnvironmentMap.from_array(self.sky, device=dev)
        self.camera = driving.program_cameras([self.cam], "medium")[0]
        self.cfg = prb.PRBConfig(**config["integrator"])
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed % 2 ** 63)
        self._models, self._prb = models, prb
        self.pixels = self._chosen(traffic["check"])
        self.kept = {}

    def _chosen(self, check: dict) -> torch.Tensor:
        """Flat indices of the compared pixels: the central block, then
        pixels drawn from the seed among the others."""
        c = min(check["center"], self.h, self.w)
        y0, x0 = (self.h - c) // 2, (self.w - c) // 2
        ys, xs = np.meshgrid(np.arange(y0, y0 + c), np.arange(x0, x0 + c), indexing="ij")
        center = (ys * self.w + xs).reshape(-1)
        others = np.setdiff1d(np.arange(self.h * self.w), center)
        rng = np.random.default_rng(self.seed % 2 ** 64)
        drawn = rng.choice(others, min(check["random"], others.size), replace=False)
        return torch.from_numpy(np.concatenate([center, drawn]).astype(np.int64)).to(self.dev)

    def frame(self):
        return self._models.render(self.scene, self.camera, self._prb.radiance, self.cfg,
                                   self.emitter, spp=self.spp, generator=self.gen)

    def _keep(self, name, state, img) -> None:
        self.kept[name] = (state, img.reshape(-1, 3)[self.pixels].clone())

    def setup(self) -> None:
        with torch.no_grad():
            for _ in range(self.traffic["warm_frames"]):
                self.frame()
        driving.sync(self.dev)

    def window(self, seconds: float) -> dict:
        times, n, failed = [], 0, 0
        with torch.no_grad():
            driving.sync(self.dev)
            t0 = time.perf_counter()
            while True:
                state = self.gen.get_state()
                t = time.perf_counter()
                img = self.frame()
                driving.sync(self.dev)
                times.append(time.perf_counter() - t)
                failed += int(not bool(torch.isfinite(img).all()))
                if n == 0 and self.traffic["compared_frames"] > 1:
                    self._keep("first", state, img)
                last = (state, img)
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
        self._keep("last", *last)
        ms = sorted(t * 1e3 for t in times)
        print(f"window: {n} frames in {wall:.6f} s, frame ms min {ms[0]:.3f} median "
              f"{float(np.median(ms)):.3f} max {ms[-1]:.3f}", flush=True)
        return dict(metrics={"frame_ms": wall / n * 1e3}, attempted=n, failed=failed)

    def traced(self, profile) -> dict:
        n = self.traffic["traced_frames"]
        frames = []

        def run():
            with torch.no_grad():
                for _ in range(n):
                    frames.append((self.gen.get_state(), self.frame()))
            return n

        rec = profile(run)
        for i, (state, img) in enumerate(frames):
            self._keep(f"traced{i}", state, img)
        self.traced_states = [state for state, _ in frames]
        return rec

    # ---- the reference side ---------------------------------------------

    def _ref_parts(self):
        return (ref_pt.Medium(self.arrays, float(self.config["extent"]), self.dev),
                ref_pt.Sky(self.sky, self.dev), ref_scene.camera_of(self.cam))

    def _replay(self, state) -> list:
        """Per pass of the frame that started at generator ``state``: the
        film positions px, py [H W] and the table of its render key."""
        g = torch.Generator(device=self.dev)
        g.set_state(state)
        h, w, dev = self.h, self.w, self.dev
        px0 = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w).reshape(-1)
        py0 = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w).reshape(-1)
        n_bounces = self.cfg.num_bounces
        passes = []
        for _ in range(self.spp):
            off = torch.rand((h * w, 2), generator=g, device=dev, dtype=torch.float32)
            key = torch.randint(0, ref_pt.KEY_RANGE, (1,), generator=g, device=dev,
                                dtype=torch.int64)
            passes.append((px0 + off[:, 0], py0 + off[:, 1], ref_pt.bounce_table(key, n_bounces)))
        return passes

    def _trace(self, parts, passes, picks, counts=None):
        """The reference's radiance of the samples ``picks`` (per pass, flat
        sample indices into that pass's wavefront)."""
        medium, sky, cam = parts
        px = torch.cat([p[0][i] for p, i in zip(passes, picks)])
        py = torch.cat([p[1][i] for p, i in zip(passes, picks)])
        which = torch.cat([torch.full_like(i, k) for k, i in enumerate(picks)])
        tables = torch.stack([p[2] for p in passes])
        o, d = ref_pt.rays(cam, px, py)
        return ref_pt.trace(medium, sky, self.config["integrator"], o, d, torch.cat(picks),
                            lambda b: tables[which, b], counts)

    def reference_pixels(self, parts, state) -> torch.Tensor:
        """The reference's developed values [P, 3] at the chosen pixels of
        the frame that started at generator ``state``."""
        passes = self._replay(state)
        targets = [torch.clamp(px.to(torch.int64), 0, self.w - 1)
                   + self.w * torch.clamp(py.to(torch.int64), 0, self.h - 1)
                   for px, py, _ in passes]
        picks = [torch.nonzero(torch.isin(t, self.pixels))[:, 0] for t in targets]
        radiance = self._trace(parts, passes, picks)
        img = torch.zeros((self.h * self.w, 3), device=self.dev)
        wgt = torch.zeros((self.h * self.w,), device=self.dev)
        start = 0
        for t, i in zip(targets, picks):
            part = radiance[start:start + i.numel()]
            start += i.numel()
            img = img + torch.zeros_like(img).index_add_(0, t[i], part)
            wgt = wgt + torch.zeros_like(wgt).index_add_(0, t[i], torch.ones_like(part[:, 0]))
        return img[self.pixels] / torch.clamp(wgt[self.pixels, None], min=1e-8)

    def count_work(self, rec: dict) -> None:
        """The traced frame's work, from the reference's own per-bounce live
        rays and collected intervals on ``work_rays`` of its samples drawn
        from the seed, scaled to the whole frame."""
        parts = self._ref_parts()
        n_work = self.traffic["work_rays"]
        total = self.spp * self.h * self.w
        rng = np.random.default_rng(self.seed % 2 ** 64 + 1)
        slots = np.sort(rng.choice(total, min(n_work, total), replace=False))
        per = self.h * self.w
        works = []
        with torch.no_grad():
            for state in self.traced_states:
                passes = self._replay(state)
                picks = [torch.from_numpy(slots[(slots >= k * per) & (slots < (k + 1) * per)]
                                          - k * per).to(self.dev) for k in range(self.spp)]
                counts = {}
                self._trace(parts, passes, picks, counts)
                works.append(work_pt.frame_work(counts, total / slots.size, self.config["n_prims"],
                                                self.config["integrator"]))
        rec["work"] = work_pt.total(works)

    def check(self) -> list:
        self.__dict__.pop("scene", None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        parts = self._ref_parts()
        gaps, flips = [], []
        with torch.no_grad():
            for name, (state, prog) in sorted(self.kept.items()):
                want = self.reference_pixels(parts, state)
                rms, flip, worst = compare(prog, want)
                gaps.append(rms)
                flips.append(flip)
                print(f"frame {name}: {self.pixels.numel()} pixels, rms gap {rms:.6e}, flip share "
                      f"{flip:.6e}, largest relative gap {worst:.6e}", flush=True)
        return [("frame_rms_gap", max(gaps)), ("flip_share", max(flips))]

    def control(self) -> list:
        """The control's numbers: the reference with its pair math in
        bfloat16 in the program's place, against the reference, on the
        frame from the seeded generator's first state."""
        parts = self._ref_parts()
        state = self.gen.get_state()
        saved = ref_pt.PAIR_DTYPE
        ref_pt.PAIR_DTYPE = torch.bfloat16
        try:
            with torch.no_grad():
                self.kept = {"control": (state, self.reference_pixels(parts, state))}
        finally:
            ref_pt.PAIR_DTYPE = saved
        return self.check()


def compare(prog: torch.Tensor, want: torch.Tensor) -> tuple:
    """(RMS gap over RMS reference, share of flipped pixels, largest
    relative gap) of the program's pixels [P, 3] against the reference's.
    A pixel that is not finite flips, and makes the RMS gap NaN or inf."""
    p, r = prog.double(), want.double()
    rel = (p - r).abs().amax(-1) / torch.clamp(r.abs().amax(-1), min=1e-30)
    rel = torch.where(torch.isfinite(rel), rel, torch.inf)
    flip = float((rel > FLIP).double().mean())
    gap, den = float(torch.sum((p - r) ** 2)), float(torch.sum(r ** 2))
    rms = (gap / den) ** 0.5 if den > 0 else (0.0 if gap == 0 else float("inf"))
    return rms, flip, float(rel.max())
