"""The port's CameraSpecs against the JAX package's.

The port keeps the JAX package's public names, so a camera record must take
the same fields in the same order with the same defaults: positional
construction then means the same in both packages. The distortion and clip
fields are carried, not applied to rays, in both; the rays of a camera built
positionally (principal point offset, clip planes and distortion set) agree
within 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

from volprim_tpu import scene as jscene
from volprim_tpu_torch import scene as tscene


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_fields_match_jax_in_order():
    assert _fields(tscene.CameraSpecs) == _fields(jscene.CameraSpecs)


@pytest.mark.parametrize(
    "extra",
    [
        (),  # the defaults
        (0.25, 40.0),  # near and far clip: carried, not applied
        (0.25, 40.0, 3.5, -2.0),  # then the principal-point offsets
        (0.25, 40.0, 3.5, -2.0, 0.1, -0.05, 0.01, 0.0, 0.0, 0.0, 1e-3, -1e-3),
    ],
)
def test_positional_camera_gives_the_same_rays(extra):
    pose = np.asarray(jscene.look_at([0.3, 0.4, -3.0], [0, 0, 0], [0, 1, 0]))
    args = ("c", 24, 16, pose, 50.0, None) + extra
    jcam, tcam = jscene.CameraSpecs(*args), tscene.CameraSpecs(*args)
    assert dataclasses.asdict(jcam).keys() == dataclasses.asdict(tcam).keys()
    for name in ("near_clip", "far_clip", "cx", "cy", "k1", "p2", "focal_length"):
        assert getattr(tcam, name) == getattr(jcam, name)
    jo, jd = jscene.generate_rays(jcam, jitter=False)
    to, td = tscene.generate_rays(tcam, jitter=False, device="cpu")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    assert td.dtype == torch.float32
