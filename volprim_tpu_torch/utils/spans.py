"""Named host spans and counters of the program, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session is active
(``torch.autograd._profiler_enabled()``); there is no other switch. Off,
:func:`span` returns one shared no-op context and :func:`count` returns at
once: a check of about 0.1 us, where entering ``record_function`` would cost
some 10 us even with no profiler running. On, a span enters
``torch.profiler.record_function(name)``, so it lands in the profiler's
Chrome trace as a ``user_annotation`` range on the same clock as the device's
kernels, with the launch of each kernel inside the range of the stage that
made it; it also adds its call and its host time (``time.perf_counter_ns``)
to an in-memory record. :func:`spanned` is the same span around a whole
function, decided at each call.

Spans nest by the clock of their thread. The backward's spans
(``composite3.bwd``, the checkpoint's recompute of ``tomography.chunk``) run
on the autograd engine's device thread on a card, and fall inside their
step's ``autograd.backward`` range by time, not as its children on one
thread.

Counters record only while tracing is on. Python ints are summed as they
come; device tensors are kept as they are and summed in :func:`snapshot`,
so that counting adds no device operation to a traced window. Call
:func:`snapshot` after the window: it returns ``{"spans": {name: {"calls",
"host_s"}}, "counters": {name: int}, "launches": {kernel: int}}``, the last
read from the kernel wrappers' own ``launches`` attributes (totals since the
process started). :func:`reset` clears the record.
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import nullcontext

import torch

_enabled = torch.autograd._profiler_enabled
_OFF = nullcontext()
_lock = threading.Lock()
_spans: dict = {}  # name -> [calls, host ns]
_ints: dict = {}  # counter -> int
_tensors: dict = {}  # counter -> [device tensors not summed yet]

# (snapshot key, kernels module, wrapper whose ``launches`` counts the kernel)
_LAUNCHES = (
    ("composite3.fwd", "composite3", "composite_tiles3"),
    ("composite3.fwd_ablated", "composite3", "forward3_ablated"),
    ("composite3.bwd", "composite3", "composite_tiles3_bwd"),
    ("composite.fwd", "composite", "composite_tiles"),
    ("composite.bwd", "composite_vjp", "composite_tiles_bwd"),
    ("composite2.fwd", "composite2", "composite_tiles2"),
    ("composite2.bwd", "composite2", "composite_tiles2_bwd"),
    ("ffwalk.walk", "ffwalk", "walk"),
    ("clone", "clone", "clone"),
)


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        self.range.__exit__(*exc)
        with _lock:
            rec = _spans.setdefault(self.name, [0, 0])
            rec[0] += 1
            rec[1] += ns


def span(name: str):
    """A context manager: the range ``name`` while tracing is on, else a
    no-op."""
    return _Span(name) if _enabled() else _OFF


def spanned(name: str):
    """Decorator: the whole call is the span ``name`` (see :func:`span`)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a tensor to be summed later) to the
    counter ``name`` while tracing is on."""
    if not _enabled():
        return
    with _lock:
        if isinstance(value, torch.Tensor):
            _tensors.setdefault(name, []).append(value)
        else:
            _ints[name] = _ints.get(name, 0) + int(value)


def snapshot() -> dict:
    """The record so far (see the module docstring). The tensors counted
    since the last call are summed now, once."""
    from .. import kernels

    with _lock:
        for name, parts in _tensors.items():
            total = sum(int(t.sum(dtype=torch.int64)) for t in parts)
            _ints[name] = _ints.get(name, 0) + total
        _tensors.clear()
        spans = {k: {"calls": c, "host_s": ns * 1e-9} for k, (c, ns) in _spans.items()}
        counters = dict(_ints)
    launches = {key: getattr(getattr(kernels, mod), fn).launches for key, mod, fn in _LAUNCHES}
    return {"spans": spans, "counters": counters, "launches": launches}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _ints.clear()
        _tensors.clear()
