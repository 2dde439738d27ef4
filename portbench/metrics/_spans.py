"""What the readers of the program's own record share: the host time of a
span and the total of a counter of ``volprim_tpu_torch.utils.spans``, per
step or frame of the traced window. The record holds only what ran while
the profiler was on, which in ``portbench.run`` is the traced window alone.
A program without that module has no record: the readers return None."""


def _record():
    try:
        from volprim_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.snapshot()


def span_ms(rec, unit: str, name: str):
    """Host ms inside span ``name`` per ``unit`` (0 where it never ran)."""
    if rec["unit"] != unit:
        return None
    record = _record()
    if record is None:
        return None
    s = record["spans"].get(name)
    return (s["host_s"] * 1e3 if s else 0.0) / rec["units"]


def counter(rec, unit: str, name: str):
    """Counter ``name`` per ``unit`` (0 where it never counted)."""
    if rec["unit"] != unit:
        return None
    record = _record()
    if record is None:
        return None
    return float(record["counters"].get(name, 0)) / rec["units"]
