"""The whole refine step's share of the card's f32 peak: the least time of
the compositor work that the step needs (forward and backward, from
``work/tiled``) over the device's busy time in the traced window, in %.
It bounds the kernels' rooflines from above the kernels: a kernel taken
off the path leaves its own roofline silent, not this."""


def read(rec):
    work = rec.get("work", {})
    if rec["unit"] != "step" or "fwd3" not in work or rec["busy_s"] <= 0:
        return None
    return 100.0 * (work["fwd3"]["seconds"] + work["bwd3"]["seconds"]) / rec["busy_s"]
