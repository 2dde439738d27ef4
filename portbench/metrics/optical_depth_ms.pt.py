"""Host ms in prb.optical_depth per path-traced frame (the escape test's and the shadow rays')."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "frame", "prb.optical_depth")
