"""Host ms in prb.free_flight per path-traced frame (escape test, collection, walk, post-pass)."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "frame", "prb.free_flight")
