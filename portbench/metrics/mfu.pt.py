"""The whole path-traced frame's share of the card's f32 peak: the least
time of the pair work and the walk that the frame needs (``work/pt``) over
the device's busy time in the traced window, in %."""


def read(rec):
    work = rec.get("work", {}).get("pt_frame")
    if rec["unit"] != "frame" or not work or rec["busy_s"] <= 0:
        return None
    return 100.0 * work["seconds"] / rec["busy_s"]
