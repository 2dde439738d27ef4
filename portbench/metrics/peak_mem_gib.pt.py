"""Peak device memory of the set-up and the traced path-traced frame, GiB
(``max_memory_allocated`` over the traced window)."""


def read(rec):
    if rec["unit"] != "frame" or rec["peak_bytes"] <= 0:
        return None
    return rec["peak_bytes"] / 2 ** 30
