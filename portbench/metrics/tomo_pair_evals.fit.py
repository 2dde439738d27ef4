"""(ray, primitive) pairs the tomography integrator evaluated per fit step, recompute included."""

from portbench.metrics._spans import counter


def read(rec):
    return counter(rec, "step", "tomography.pair_evals")
