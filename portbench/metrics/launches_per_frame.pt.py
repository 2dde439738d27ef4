"""Device operations launched per path-traced frame."""

from portbench.metrics._device import launches


def read(rec):
    return launches(rec, "frame")
