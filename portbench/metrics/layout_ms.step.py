"""Host ms in rf_tiled.layout per refine step (tile grids and camera uploads)."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "step", "rf_tiled.layout")
