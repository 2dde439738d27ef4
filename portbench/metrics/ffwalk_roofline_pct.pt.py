"""The free-flight walk (csrc/ffwalk.cu, kernel ffwalk_kernel) in the
path-traced frames: the least time of the work the frame's walks needed
(``work/pt``) over the kernel's device time, in %."""

from portbench.metrics._roofline import share


def read(rec):
    if rec["unit"] != "frame":
        return None
    return share(rec, "ffwalk", "ffwalk_kernel")
