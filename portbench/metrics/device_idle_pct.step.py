"""The device's idle share of the traced window, refine steps."""

from portbench.metrics._device import idle_pct


def read(rec):
    return idle_pct(rec, "step")
