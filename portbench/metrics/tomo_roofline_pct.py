"""The whole tomography step's share of the card's peak: the least time
of the forward and backward pair work (``work/tomo``) over the device's
busy time in the traced window, in %. The step has no kernel of its own,
so it is bounded as a whole."""


def read(rec):
    work = rec.get("work", {}).get("tomo_step")
    if not work or rec["busy_s"] <= 0:
        return None
    return 100.0 * work["seconds"] / rec["busy_s"]
