"""Host ms in rf_tiled.layout per viewer frame (tile grid and camera uploads)."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "frame", "rf_tiled.layout")
