"""The device's idle share of the traced window, path-traced frames."""

from portbench.metrics._device import idle_pct


def read(rec):
    return idle_pct(rec, "frame")
