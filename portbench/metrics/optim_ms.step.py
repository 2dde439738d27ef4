"""Host ms in optim.step per refine step (BoundedAdam.step)."""

from portbench.metrics._spans import span_ms


def read(rec):
    return span_ms(rec, "step", "optim.step")
