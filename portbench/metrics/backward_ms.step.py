"""Host ms in autograd.backward per refine step (loss.backward())."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "step", "autograd.backward")
