"""Segments the forward compositor walked per viewer frame, over every tile."""

from portbench.metrics._spans import counter


def read(rec):
    return counter(rec, "frame", "composite3.segments_walked")
