"""diag2m's budget-bound configurations (budget, pool, pool-hi) against the
root tools/diag2m.py where the candidate budget binds, on the CPU.

At tests/test_torch_diag2m.py's 2,000 primitives no budget binds (125
clusters against a budget of 128), so there budget, pool and pool-hi give
the ordering frame. Here bench's scene of 16,384 primitives (1,024
clusters) at 64 x 64 (16 tiles, the subsample the whole film): up to 379
clusters meet a tile's cone against the 128 of 2,048 candidates, so the
shortlist truncates, and the coarse pooling (gc=4) picks what it keeps.

Each configuration's frame is held as test_torch_diag2m.py holds ceiling
and ordering: in f64, the port (``_render64``) within FRAME_TOL of JAX's
xla route (``jax_render64``) on the f32 frame's shortlists; in f32 the
port's RMS and largest deviation from JAX's f64 frame at most twice and
four times JAX's f32 frame's; its PSNR against the exact reference (the
port's, max_depth 512, in f32) at most twice as far from the f64 frame's
PSNR as JAX's f32 frame's.
"""

import numpy as np
import pytest
import torch

import bench
from volprim_tpu import scene as jscene
from volprim_tpu_torch.models import rf_tiled as trt
from volprim_tpu_torch.scene import generate_rays, synthetic
from volprim_tpu_torch.tools import analyze_rf, diag2m, studies

from test_torch_diag2m import _jax_frame, _jax_kw, _rms_max
from test_torch_rf_tiled_xla import FRAME_TOL, _render64, _scene64, jax_render64

N, WIDTH = 16384, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def study():
    """Both packages' scenes and cameras, the subsample and the port's
    exact reference on it (primitives in chunks of 1,024: memory)."""
    from volprim_tpu_torch.models import rf

    ts, tcam = synthetic.make_scene(N, device="cpu"), synthetic.headline_camera(WIDTH)
    jcam = jscene.CameraSpecs(name="bench2m", width=WIDTH, height=WIDTH,
                              to_world=jscene.look_at([0, 0.4, -3.2], [0, 0, 0], [0, 1, 0]),
                              fov=50.0)
    sel = studies.subsample(WIDTH * WIDTH, diag2m.SUBSAMPLE_SEED)
    idx = torch.from_numpy(sel)
    o, d = generate_rays(tcam, jitter=False, device="cpu")
    exact = rf.radiance(ts, None, o[idx], d[idx], rf.RFConfig(
        max_depth=diag2m.MD_REF, srgb_primitives=True, chunk_size=1024)).numpy()
    return dict(ts=ts, tcam=tcam, js=bench.make_scene(N), jcam=jcam, sel=sel, idx=idx, d=d,
                exact=exact)


def test_the_budget_binds(study):
    """Tiles whose cone meets more clusters than 2,048 candidates hold."""
    cfg = diag2m.config(diag2m.CONFIGS["budget"])
    state = trt.build_state(study["ts"], cfg)
    origin = torch.as_tensor(study["tcam"].to_world[:3, 3], dtype=torch.float32)
    need = analyze_rf.need(state, origin, *analyze_rf.cones(
        analyze_rf.tile_rays(study["d"], WIDTH, WIDTH, diag2m.TILE_PIXELS, False)))
    print("clusters meeting each tile's cone:", need.tolist())
    assert int((need > 2048 // cfg.cluster_size).sum()) >= 4


@pytest.mark.parametrize("name", ["budget", "pool", "pool-hi"])
def test_budget_config_matches_jax(study, name):
    p = diag2m.CONFIGS[name]
    cfg = diag2m.config(p)
    idx, sel, exact = study["idx"], study["sel"], study["exact"]
    got = trt.render_state(trt.build_state(study["ts"], cfg), study["tcam"], cfg, None, spp=1,
                           seed=0, jitter=False).reshape(-1, 3)[idx].numpy()
    want = _jax_frame(study["js"], study["jcam"], sel, p)
    got64 = _render64(_scene64(study["js"]), study["tcam"], cfg).reshape(-1, 3)[idx].numpy()
    want64 = jax_render64(study["js"], study["jcam"], _jax_kw(p)).reshape(-1, 3)[sel]
    np.testing.assert_allclose(got64, want64, rtol=0, atol=FRAME_TOL)
    d_t, d_j = _rms_max(got, want64), _rms_max(want, want64)
    psnr64 = studies.psnr(torch.from_numpy(want64), torch.from_numpy(exact))
    psnr_t = studies.psnr(torch.from_numpy(got), torch.from_numpy(exact))
    psnr_j = studies.psnr(torch.from_numpy(want), torch.from_numpy(exact))
    print(f"{name}: f64 {psnr64:.5f} dB; port {psnr_t:.5f}, JAX {psnr_j:.5f} dB; "
          f"frames from f64 (rms, max) port {d_t} JAX {d_j}")
    assert d_t[0] <= 2 * d_j[0] and d_t[1] <= 4 * d_j[1]
    assert abs(psnr_t - psnr64) <= 2 * abs(psnr_j - psnr64)
