"""(ray, primitive) pairs prb.optical_depth evaluated per path-traced frame, padding included."""

from portbench.metrics._spans import counter


def read(rec):
    return counter(rec, "frame", "prb.depth_pairs")
