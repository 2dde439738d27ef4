"""What several readers share: the device's idle share, the launches per
step or frame, and the peak memory of the traced window."""


def idle_pct(rec, unit: str):
    """1 - busy / wall over the traced window, in %."""
    if rec["unit"] != unit or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def launches(rec, unit: str):
    """Device operations (kernels, copies, fills) launched per step or
    frame in the traced window: the host dispatch's work."""
    if rec["unit"] != unit or rec["launches"] == 0:
        return None
    return rec["launches"] / rec["units"]


def peak_gib(rec):
    """``max_memory_allocated`` over the traced window (after
    ``reset_peak_memory_stats``), GiB."""
    if rec["unit"] != "step" or rec["peak_bytes"] <= 0:
        return None
    return rec["peak_bytes"] / 2 ** 30
