"""Host ms in rf_tiled.cull per viewer frame (tile cones, two-level cull, shortlists)."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "frame", "rf_tiled.cull")
