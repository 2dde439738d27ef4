"""The share of its roofline that a kernel reached in the traced window:
the least time of the work its calls needed (``portbench/work``) over the
device time of the kernels whose name holds the kernel's name."""


def share(rec, work_key: str, kernel: str):
    work = rec.get("work", {}).get(work_key)
    secs = sum(s for n, s in rec["by_name"].items() if kernel in n)
    if not work or secs <= 0:
        return None
    return 100.0 * work["seconds"] / secs
