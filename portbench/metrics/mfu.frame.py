"""The whole frame's share of the card's f32 peak: the least time of the
compositor work that the frames need (``work/tiled``) over the device's
busy time in the traced window, in %."""


def read(rec):
    work = rec.get("work", {})
    if rec["unit"] != "frame" or "fwd3" not in work or rec["busy_s"] <= 0:
        return None
    return 100.0 * work["fwd3"]["seconds"] / rec["busy_s"]
