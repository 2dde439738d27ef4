"""Device operations launched per refine step."""

from portbench.metrics._device import launches


def read(rec):
    return launches(rec, "step")
