"""Device operations launched per viewer frame."""

from portbench.metrics._device import launches


def read(rec):
    return launches(rec, "frame")
