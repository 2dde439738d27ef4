"""The forward compositor (csrc/composite3_fwd.cu, kernel fwd3_kernel) in
the step cells: least time / its device time, in %."""

from portbench.metrics._roofline import share


def read(rec):
    if rec["unit"] != "step":
        return None
    return share(rec, "fwd3", "fwd3_kernel")
