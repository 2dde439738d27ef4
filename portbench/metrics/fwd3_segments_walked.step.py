"""Segments the forward compositor walked per refine step, over every tile."""

from portbench.metrics._spans import counter


def read(rec):
    return counter(rec, "step", "composite3.segments_walked")
