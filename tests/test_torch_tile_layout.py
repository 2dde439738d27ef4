"""The tiled renderer's film layouts (``rf_tiled._tile_layout``): built once
per film on the device and shared by every later camera of that film.

The cached layout against the grid as it was built for each camera before
(a copy below), bit for bit, at the viewer's film, a film whose strips fall
back to row-consecutive ones and an explicit tile shape; ``unshuffle``; the
build and hit counters; the bound of the cache, also under threads; the cached tensors left as
they were by renders; the camera's numbers in one upload against separate
ones; a frame from a cached layout against one that built its own, for
cameras with their own principal points."""

import dataclasses
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volprim_tpu_torch.models import rf_tiled
from volprim_tpu_torch.scene import synthetic
from volprim_tpu_torch.scene.cameras import CameraSpecs, look_at
from volprim_tpu_torch.utils import spans

CPU = torch.device("cpu")
# the renderer at test size: 16 tiles of 64 rays a 32^2 camera
SMALL = rf_tiled.RFTiledConfig(
    max_depth=64, tile_pixels=64, max_candidates=128, segment=64, cluster_size=16,
    backend="fused", early_exit=True, coarse_group=4, coarse_factor=8, super_group=4,
)
# (film width, height, config): the viewer's film (16 x 16 tiles in 2 x 2
# strips), 6 x 5 tiles whose strips of 4 fall back to rows, explicit 8 x 16
FILMS = [
    (960, 544, rf_tiled.RFTiledConfig(tile_pixels=256, coarse_group=4)),
    (48, 40, rf_tiled.RFTiledConfig(tile_pixels=64, coarse_group=4)),
    (64, 32, rf_tiled.RFTiledConfig(tile_shape=(8, 16), coarse_group=4)),
]


@pytest.fixture(autouse=True)
def _fresh_cache():
    rf_tiled._LAYOUTS.clear()
    spans.reset()
    yield
    rf_tiled._LAYOUTS.clear()
    spans.reset()


def camera(width, height, cx=0.0, cy=0.0, eye=(0.0, 0.4, -3.2)):
    return CameraSpecs(name="cam", width=width, height=height, fov=50.0, cx=cx, cy=cy,
                       to_world=look_at(list(eye), [0, 0, 0], [0, 1, 0]))


def per_camera_layout(cam, cfg):
    """The layout as it was built for every camera: int64 grids on the host,
    cast and copied."""
    h, w = cam.height, cam.width
    if cfg.tile_shape is not None:
        th, tw = cfg.tile_shape
    else:
        tp = cfg.tile_pixels
        th = int(tp**0.5)
        while tp % th or h % th:
            th -= 1
        tw = tp // th
    n_ty, n_tx = h // th, w // tw
    n_tiles = n_ty * n_tx
    rt = th * tw
    gc = max(1, cfg.coarse_group)
    gb_y = max(1, int(round(gc ** 0.5)))
    while gb_y > 1 and (gc % gb_y or n_ty % gb_y or n_tx % (gc // gb_y)):
        gb_y -= 1
    gb_x = gc // gb_y if gc % gb_y == 0 and n_tx % (gc // gb_y) == 0 else 1
    if gb_x == 1:
        gb_y = 1
    n_gy, n_gx = n_ty // gb_y, n_tx // gb_x
    ty_of = (torch.arange(n_ty).reshape(n_gy, 1, gb_y, 1).expand(n_gy, n_gx, gb_y, gb_x)
             .reshape(-1))
    tx_of = (torch.arange(n_tx).reshape(1, n_gx, 1, gb_x).expand(n_gy, n_gx, gb_y, gb_x)
             .reshape(-1))
    ys = torch.arange(h).reshape(n_ty, th)[ty_of]
    xs = torch.arange(w).reshape(n_tx, tw)[tx_of]
    py0 = ys[:, :, None].expand(n_tiles, th, tw).reshape(n_tiles, rt)
    px0 = xs[:, None, :].expand(n_tiles, th, tw).reshape(n_tiles, rt)

    def unshuffle(acc):
        return (acc.reshape(n_gy, n_gx, gb_y, gb_x, th, tw, 3).permute(0, 2, 4, 1, 3, 5, 6)
                .reshape(h, w, 3))

    f32 = torch.float32
    return px0.to(f32), py0.to(f32), torch.arange(n_tiles), unshuffle, (gb_y, gb_x)


def recorded():
    """The layout counters recorded so far."""
    return {k: v for k, v in spans.snapshot()["counters"].items() if k.startswith("rf_tiled.")}


@pytest.mark.parametrize("width,height,cfg", FILMS, ids=["view960", "rows", "tile_shape"])
def test_cached_layout_is_the_per_camera_grid(width, height, cfg):
    cam = camera(width, height)
    want_x, want_y, want_ids, want_un, strips = per_camera_layout(cam, cfg)
    if width == 960:
        assert strips == (2, 2)
    elif width == 48:
        assert strips == (1, 1)
    first = rf_tiled._tile_layout(cam, cfg, CPU)
    again = rf_tiled._tile_layout(camera(width, height, cx=1.5, eye=(1.0, 0.2, 3.0)), cfg, CPU)
    assert all(a is b for a, b in zip(first, again))
    px0, py0, ids, unshuffle = first
    for got, want in ((px0, want_x), (py0, want_y), (ids, want_ids)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    acc = torch.randn((px0.shape[0], px0.shape[1], 3), generator=torch.Generator().manual_seed(1))
    film = unshuffle(acc)
    assert torch.equal(film, want_un(acc))
    # each film pixel holds the value of the ray at its own coordinates
    y, x = py0.long(), px0.long()
    assert torch.equal(film[y, x], acc)


def test_builds_and_hits_are_counted():
    view = FILMS[0][2]  # 16 x 16 tiles in strips of 4
    with profile(activities=[ProfilerActivity.CPU]):
        rf_tiled._tile_layout(camera(96, 64), view, CPU)
        assert recorded() == {"rf_tiled.layout_builds": 1}
        rf_tiled._tile_layout(camera(96, 64, cx=2.0, cy=-1.0, eye=(3.0, 0.0, 0.0)), view, CPU)
        assert recorded() == {"rf_tiled.layout_builds": 1, "rf_tiled.layout_hits": 1}
        rf_tiled._tile_layout(camera(96, 48), view, CPU)  # another film
        rf_tiled._tile_layout(camera(96, 64), dataclasses.replace(view, coarse_group=2), CPU)
        # the same tiles by shape or by count share a layout
        rf_tiled._tile_layout(camera(96, 64), dataclasses.replace(view, tile_shape=(16, 16)),
                              CPU)
        assert recorded() == {"rf_tiled.layout_builds": 3, "rf_tiled.layout_hits": 2}
    assert len(rf_tiled._LAYOUTS) == 3
    rf_tiled._tile_layout(camera(96, 64), view, CPU)  # no profiler: nothing counted
    assert recorded() == {"rf_tiled.layout_builds": 3, "rf_tiled.layout_hits": 2}


def test_cache_keeps_the_recent_films():
    cfg = rf_tiled.RFTiledConfig(tile_pixels=64, coarse_group=4)
    first = rf_tiled._tile_layout(camera(32, 32), cfg, CPU)
    for i in range(1, rf_tiled._LAYOUT_CACHE):
        rf_tiled._tile_layout(camera(32, 32 + 8 * i), cfg, CPU)
    assert rf_tiled._tile_layout(camera(32, 32), cfg, CPU)[0] is first[0]  # now most recent
    rf_tiled._tile_layout(camera(32, 8), cfg, CPU)  # evicts 32 x 40, the least recent
    assert len(rf_tiled._LAYOUTS) == rf_tiled._LAYOUT_CACHE
    heights = [key[0] for key in rf_tiled._LAYOUTS]
    assert 40 not in heights and heights[-2:] == [32, 8]
    with pytest.raises(ValueError, match="not divisible"):
        rf_tiled._tile_layout(camera(36, 32), cfg, CPU)
    assert len(rf_tiled._LAYOUTS) == rf_tiled._LAYOUT_CACHE


def test_threads_share_the_cache():
    """More threads than cores over more films than the cache holds, with a
    short switch interval: every call gets its own film's layout and the
    cache keeps its bound."""
    cfg = rf_tiled.RFTiledConfig(tile_pixels=64, coarse_group=4)
    films = [(32, 8 * (i + 1)) for i in range(rf_tiled._LAYOUT_CACHE + 4)]
    errors = []

    def work(k):
        try:
            for j in range(200):
                w, h = films[(k + j) % len(films)]
                px0, py0, ids, _ = rf_tiled._tile_layout(camera(w, h), cfg, CPU)
                assert px0.shape == (h * w // 64, 64) and int(py0.max()) == h - 1
        except Exception as e:  # noqa: BLE001 - handed to the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(rf_tiled._LAYOUTS) == rf_tiled._LAYOUT_CACHE


def test_camera_numbers_are_the_separate_uploads():
    cam = camera(960, 544, cx=3.25, cy=-7.1, eye=(0.3, 1.7, -2.9))
    f32 = torch.float32
    origin, rot, focal, ppx, ppy = rf_tiled._camera_numbers(cam, CPU)
    want = (
        torch.as_tensor(cam.to_world[:3, 3], dtype=f32),
        torch.as_tensor(cam.to_world[:3, :3], dtype=f32),
        torch.tensor(cam.focal_length, dtype=f32),
        torch.tensor(cam.width / 2.0 - cam.cx, dtype=f32),
        torch.tensor(cam.height / 2.0 - cam.cy, dtype=f32),
    )
    for got, w in zip((origin, rot, focal, ppx, ppy), want):
        assert got.dtype == f32 and got.shape == w.shape and torch.equal(got, w)


@pytest.fixture(scope="module")
def small_state():
    scene = synthetic.make_scene(512, seed=3, device="cpu")
    with torch.no_grad():
        return rf_tiled.build_state(scene, SMALL)


def render(state, cam, seed=0):
    with torch.no_grad():
        return rf_tiled.render_state(state, cam, SMALL, spp=2, seed=seed)


def test_renders_leave_the_cached_layout_unchanged(small_state):
    cam = camera(32, 32)
    px0, py0, ids, _ = rf_tiled._tile_layout(cam, SMALL, CPU)
    kept = [t.clone() for t in (px0, py0, ids)]
    render(small_state, cam)
    render(small_state, camera(32, 32, cx=0.5, eye=(2.0, 1.0, -2.0)), seed=1)
    assert rf_tiled._LAYOUTS[next(iter(rf_tiled._LAYOUTS))][0] is px0
    for t, k in zip((px0, py0, ids), kept):
        assert torch.equal(t, k)


def test_principal_point_on_a_cached_film(small_state):
    """A camera with its own cx / cy renders from the film's cached layout
    what it renders from a layout built for it alone."""
    render(small_state, camera(32, 32))  # builds the film's layout
    shifted = camera(32, 32, cx=2.5, cy=-1.25, eye=(1.0, 0.6, -3.0))
    with profile(activities=[ProfilerActivity.CPU]):
        cached = render(small_state, shifted, seed=4)
    assert recorded() == {"rf_tiled.layout_hits": 1}
    rf_tiled._LAYOUTS.clear()
    fresh = render(small_state, shifted, seed=4)
    assert torch.isfinite(cached).all() and cached.abs().sum() > 0
    assert torch.equal(cached, fresh)
    # the shift reaches the rays: the unshifted camera at that eye differs
    assert not torch.equal(cached, render(small_state, dataclasses.replace(shifted, cx=0.0,
                                                                           cy=0.0), seed=4))
