"""Host ms in prb.nee per path-traced frame (emitter sampling, shadow rays, MIS)."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "frame", "prb.nee")
