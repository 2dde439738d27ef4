"""Peak device memory of the traced refine steps, GiB."""

from portbench.metrics._device import peak_gib


def read(rec):
    return peak_gib(rec)
