"""The port's numpy-only synthetic scene is bench.make_scene bit for bit."""

import numpy as np

import bench
from volprim_tpu_torch.scene import synthetic


def test_make_scene_bitwise_equals_bench():
    ref = bench.make_scene(4096)
    got = synthetic.make_scene(4096, device="cpu")
    for name in ("centers", "scales", "quats"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        )
    assert set(got.attrs) == set(ref.attrs)
    for k in ref.attrs:
        np.testing.assert_array_equal(got.attrs[k].numpy(), np.asarray(ref.attrs[k]))
    assert got.extent == ref.extent


def test_interop_round_trip():
    from volprim_tpu_torch import interop

    a = synthetic.make_scene_arrays(256, seed=1)
    attrs = {"opacities": a["opacities"], "sh_coeffs": a["sh_coeffs"]}
    scene = interop.scene_from_arrays(
        a["centers"], a["scales"], a["quats"], attrs, 2.5, device="cpu"
    )
    back = interop.to_numpy(scene)
    for name in ("centers", "scales", "quats"):
        np.testing.assert_array_equal(back[name], a[name])
    for k, v in attrs.items():
        np.testing.assert_array_equal(back["attrs"][k], v)
    assert back["extent"] == 2.5 and scene.num_prims == 256
