"""volprim_tpu_torch.accel against volprim_tpu.accel on the same numpy
inputs: Morton codes and permutations exactly, bounding spheres within
rtol 1e-6, cone keys within rtol 1e-5 with identical finiteness, and
shortlist ids identical on finite keys (ties included)."""

import jax.numpy as jnp
import numpy as np
import torch

from volprim_tpu.accel import clusters as jcl
from volprim_tpu.accel import tiles as jtiles
from volprim_tpu.models import base as jbase
from volprim_tpu.scene import EllipsoidScene as JScene
from volprim_tpu_torch import interop
from volprim_tpu_torch.accel import clusters as tcl
from volprim_tpu_torch.accel import tiles as ttiles
from volprim_tpu_torch.models import base as tbase
from volprim_tpu_torch.scene import synthetic


def _scenes(n=3000, cluster_size=16):
    """The same padded surface scene in both packages."""
    a = synthetic.make_scene_arrays(n, seed=5)
    attrs = {"opacities": a["opacities"], "sh_coeffs": a["sh_coeffs"]}
    js = JScene(
        centers=jnp.asarray(a["centers"]), scales=jnp.asarray(a["scales"]),
        quats=jnp.asarray(a["quats"]),
        attrs={k: jnp.asarray(v) for k, v in attrs.items()},
    )
    ts = interop.scene_from_arrays(
        a["centers"], a["scales"], a["quats"], attrs, 3.0, device="cpu"
    )
    return (
        jbase.pad_primitives(js, cluster_size),
        tbase.pad_primitives(ts, cluster_size),
        n,
    )


def test_pad_primitives():
    js, ts, _ = _scenes()
    for name in ("centers", "scales", "quats"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    for k in js.attrs:
        np.testing.assert_array_equal(ts.attrs[k].numpy(), np.asarray(js.attrs[k]))


def test_morton_codes_identical():
    js, ts, n = _scenes()
    np.testing.assert_array_equal(
        tcl.morton_codes(ts.centers, n).numpy(),
        np.asarray(jcl.morton_codes(js.centers, n)),
    )


def test_build_clusters_and_super_spheres():
    js, ts, n = _scenes()
    ji = jcl.build_clusters(js, 16, num_real=n)
    ti = tcl.build_clusters(ts, 16, num_real=n)
    np.testing.assert_array_equal(ti.perm.numpy(), np.asarray(ji.perm))
    np.testing.assert_allclose(ti.centers.numpy(), np.asarray(ji.centers), rtol=1e-6)
    np.testing.assert_allclose(ti.radii.numpy(), np.asarray(ji.radii), rtol=1e-6)
    jsc, jsr = jcl.build_super_spheres(ji.centers, ji.radii, 4)
    tsc, tsr = tcl.build_super_spheres(ti.centers, ti.radii, 4)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
    np.testing.assert_allclose(tsr.numpy(), np.asarray(jsr), rtol=1e-6)


def _cones(seed, t):
    rng = np.random.default_rng(seed)
    axes = rng.normal(0.0, 0.3, (t, 3)) + [0.0, 0.0, 1.0]
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    cos_half = np.cos(rng.uniform(0.02, 0.3, t))
    origin = np.asarray([0.0, 0.4, -3.2])
    return [np.asarray(x, np.float32) for x in (origin, axes, cos_half)]


def _assert_keys_match(kt, kj):
    kt, kj = kt.numpy(), np.asarray(kj)
    fin = np.isfinite(kj)
    np.testing.assert_array_equal(np.isfinite(kt), fin)
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(kt[fin], kj[fin], rtol=1e-5)


def test_cone_cull_keys_batch_and_cols():
    js, ts, n = _scenes()
    ji = jcl.build_clusters(js, 16, num_real=n)
    ti = tcl.build_clusters(ts, 16, num_real=n)
    origin, axes, cos_half = _cones(1, 32)
    t = [torch.from_numpy(x) for x in (origin, axes, cos_half)]
    kb_t = ttiles.cone_cull_keys_batch(*t, ti.centers, ti.radii)
    kb_j = jtiles.cone_cull_keys_batch(origin, axes, cos_half, ji.centers, ji.radii)
    _assert_keys_match(kb_t, kb_j)
    # columns: each cone against its own gathered subset, with -1 radii slots
    cols = np.random.default_rng(2).integers(0, ji.centers.shape[0], (32, 96))
    cc = np.asarray(ji.centers)[cols]
    rr = np.asarray(ji.radii)[cols]
    rr[:, -8:] = -1.0
    kc_t = ttiles.cone_cull_keys_cols(
        *t, *(torch.from_numpy(np.ascontiguousarray(cc[..., i])) for i in range(3)),
        torch.from_numpy(rr),
    )
    kc_j = jtiles.cone_cull_keys_cols(
        origin, axes, cos_half, cc[..., 0], cc[..., 1], cc[..., 2], rr
    )
    _assert_keys_match(kc_t, kc_j)
    assert not np.isfinite(kc_t.numpy()[:, -8:]).any()


def test_shortlist_ids_identical_with_ties():
    rng = np.random.default_rng(3)
    # integer-valued depths tie often; +inf marks culled slots
    keys = rng.integers(0, 20, (16, 200)).astype(np.float32)
    keys[rng.uniform(size=keys.shape) < 0.4] = np.inf
    keys[0] = np.inf  # a row with no finite key at all
    for k in (1, 37, 200):
        ids_t, val_t = ttiles.shortlist(torch.from_numpy(keys), k)
        ids_j, val_j = jtiles.shortlist(jnp.asarray(keys), k)
        val_j = np.asarray(val_j)
        np.testing.assert_array_equal(val_t.numpy(), val_j)
        np.testing.assert_array_equal(ids_t.numpy()[val_j], np.asarray(ids_j)[val_j])
