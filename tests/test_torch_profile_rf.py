"""The port's per-stage profiler (volprim_tpu_torch.tools.profile_rf) and the
stage stops of its rf_tiled frame, on the CPU at a small size.

- The tool runs every ported stage with ``--cpu`` on an 8192-primitive
  synthetic scene and a 64x64 film (its module constants shrunk), prints a
  line per stage and the summary, and refuses what is not ported
  (``--feat_major``, ``--kernel_batch 2``), the ``abl_*`` stages with
  ``--cpu`` (they time variants of the CUDA kernel) and a run without a
  card unless ``--cpu`` is given.
- ``rf_tiled._DEBUG_STOP`` ("cull", "pack", "gather_pf", "gather") returns
  the same probe values as JAX's on the same scene and configuration (the
  profiler's, with refinement), within 1e-5 relative: the probes are sums
  of up to ~10^6 f32 terms taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu.models import rf_tiled as jrt
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.scene import synthetic
from volprim_tpu_torch.tools import profile_rf

N_PRIMS, WIDTH = 8192, 64


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setattr(profile_rf, "N_PRIMS", N_PRIMS)
    monkeypatch.setattr(profile_rf, "WIDTH", WIDTH)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_profiler_runs_every_ported_stage_on_cpu(capsys):
    results = profile_rf.main(["--cpu", "--reps", "2", "--stages", ",".join(profile_rf.STAGES)])
    timed = [st for st in profile_rf.STAGES if st != "segstats"]
    assert list(results) == timed
    assert all(np.isfinite(v) and v > 0 for v in results.values())
    out = capsys.readouterr().out.splitlines()
    for st in timed:
        assert any(line.startswith(f"{st:10s}") and "ms   (reps: " in line for line in out), st
    seg = [line for line in out if line.startswith("segstats: walked mean")]
    assert len(seg) == 1 and "| live mean" in seg[0]
    assert out[-1].startswith("summary: {'full': ")


@pytest.mark.parametrize(
    "argv", [["--stages", "kernel,abl_nodepth"], ["--feat_major"], ["--kernel_batch", "2"],
             ["--stages", "kernel,nosuch"]],
)
def test_unported_options_exit(argv):
    with pytest.raises(SystemExit, match="ROADMAP|unknown stage|needs the card"):
        profile_rf.main(["--cpu"] + argv)


def test_profiler_needs_a_card_without_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        profile_rf.main(["--stages", "cull"])


def _jax_scene():
    a = synthetic.make_scene_arrays(N_PRIMS)
    return jscene.EllipsoidScene(
        centers=jnp.asarray(a["centers"]), scales=jnp.asarray(a["scales"]),
        quats=jnp.asarray(a["quats"]),
        attrs={"opacities": jnp.asarray(a["opacities"]),
               "sh_coeffs": jnp.asarray(a["sh_coeffs"])},
    )


@pytest.mark.parametrize("stop", ["cull", "pack", "gather_pf", "gather"])
def test_debug_stops_match_jax(stop, monkeypatch):
    args = profile_rf._parser().parse_args(["--cpu"])
    cfg_t = profile_rf.config(args)
    cfg_j = jrt.RFTiledConfig(**{f.name: getattr(cfg_t, f.name)
                                 for f in cfg_t.__dataclass_fields__.values()})
    assert cfg_t.refine_fraction == 0.125
    cam_t = synthetic.headline_camera(WIDTH)
    cam_j = jscene.CameraSpecs(name="bench", width=WIDTH, height=WIDTH, fov=50.0,
                               to_world=cam_t.to_world)
    state_t = trt.build_state(synthetic.make_scene(N_PRIMS, device="cpu"), cfg_t)
    state_j = jrt.build_state(_jax_scene(), cfg_j)
    monkeypatch.setattr(trt, "_DEBUG_STOP", stop)
    monkeypatch.setattr(jrt, "_DEBUG_STOP", stop)
    got = trt.render_state(state_t, cam_t, cfg_t, None, spp=2, seed=0, jitter=False).numpy()
    want = np.asarray(jrt.render_state(state_j, cam_j, cfg_j, None, spp=2, seed=0,
                                       jitter=False))
    assert got.shape == want.shape == (WIDTH, WIDTH, 3)
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if stop.startswith("gather"):  # refined tiles carry their own gather's probe
        assert len(np.unique(want)) > 1
