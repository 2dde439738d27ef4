"""Host ms in rf_tiled.build_state per refine step (the state's rebuild)."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "step", "rf_tiled.build_state")
