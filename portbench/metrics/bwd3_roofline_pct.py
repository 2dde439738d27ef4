"""The backward compositor (csrc/composite3_bwd.cu, kernel bwd3_kernel):
least time / its device time, in %."""

from portbench.metrics._roofline import share


def read(rec):
    return share(rec, "bwd3", "bwd3_kernel")
