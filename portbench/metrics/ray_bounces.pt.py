"""Live rays entering a bounce, summed over the bounces of a path-traced frame."""

from portbench.metrics._spans import counter


def read(rec):
    return counter(rec, "frame", "prb.ray_bounces")
