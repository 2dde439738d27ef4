"""Device operations launched per fit step."""

from portbench.metrics._device import launches


def read(rec):
    return launches(rec, "step")
