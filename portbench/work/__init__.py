"""The yardstick of the roofline metrics: the published peaks of the card
and the operations and bytes that each piece of work needs, counted from
what the inputs need (``portbench/reference``'s own shortlists and the
configurations' shapes), never from the program's launch arguments."""

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def least_time(ops: float, nbytes: float) -> dict:
    """The least time in seconds that ``ops`` f32 operations and ``nbytes``
    bytes take on the card, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return {"seconds": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ops": ops, "bytes": nbytes}
