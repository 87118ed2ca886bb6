"""Stage wall-clock instrumentation: one trace per stage run.

The reference instruments every stage with ``msh_time_now`` pairs and prints
stage-prefixed log lines ("IO:", "POSE_PROPOSAL:", "GREEDY STEP:", ...;
SURVEY.md §5). ``stage_timer`` keeps those prefixes so existing log-scraping
works.

A stage's ``run`` opens ``stage(name, timings)`` at its first line and
closes it at its return, after its outputs are written. Inside it, every
``span(key)`` adds its block's host-clock seconds to ``timings[key]``; a
key entered again adds up, and a key entered while it is already open
adds nothing more (its time is in the outer block). The root records
``timings["stage"]`` (entry to return) and ``timings["stage_self"]`` (the
root's seconds that no span opened directly under it on the stage's own
thread covers). ``span(key, nest=False)`` times its key without being a
level of that nesting: the spans inside it count as its parent's
children (a stage's ``total``, which holds most of the stage, so that
``stage_self`` is the time under none of its substages). A worker thread
that is handed the stage's context (``contextvars.copy_context().run``)
adds its spans to the same ``timings``. Outside a stage a span records
nothing.

Every blocking read from the card on the stage's path goes through
``to_host``, every other wait on the card (a copy to it) through
``host_wait``: ``timings["host_wait"]`` is the stage thread's seconds
blocked there and ``timings["host_syncs"]`` the number of synchronising
calls, every thread's, on a CUDA device.

With ``profiler_ranges(True)`` every stage and span also opens a
``torch.profiler.record_function`` range, ``rescan.<stage>`` and
``rescan.<stage>.<key>``, so that a profiler trace shows them on the
clock of the device's events (the profiler records the ranges of the
thread that started it, not a worker's). They are off by default: the
profiler mirrors each range onto the device's timeline.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, Iterator

_RANGES = False
# (the open stage's trace, the keys open in this context)
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "rescan_tpu_torch_span", default=None)


def profiler_ranges(on: bool) -> None:
    """Open a ``torch.profiler.record_function`` range per stage and span
    from now on (``on``), or none."""
    global _RANGES
    _RANGES = bool(on)


def _range(*names: str):
    """An entered profiler range ``rescan.<names>``, or None while ranges
    are off."""
    if not _RANGES:
        return None
    import torch
    rf = torch.profiler.record_function("rescan." + ".".join(names))
    rf.__enter__()
    return rf


class _Trace:
    """One stage run: its ``timings`` and the seconds of the spans opened
    directly under its root on its thread."""

    def __init__(self, name: str, timings: Dict[str, float]):
        self.name = name
        self.timings = timings
        self.thread = threading.get_ident()
        self.direct = 0.0
        self._lock = threading.Lock()

    def add(self, key: str, value: float) -> None:
        with self._lock:
            self.timings[key] = self.timings.get(key, 0) + value


@contextlib.contextmanager
def stage(name: str, timings: Dict[str, float]) -> Iterator[Dict[str, float]]:
    """The root span of one run of stage ``name``, collecting into
    ``timings``."""
    trace = _Trace(name, timings)
    token = _OPEN.set((trace, ()))
    t0 = time.perf_counter()
    rf = _range(name)
    try:
        yield timings
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)
        dt = time.perf_counter() - t0
        _OPEN.reset(token)
        timings["stage"] = dt
        timings["stage_self"] = max(dt - trace.direct, 0.0)


class span:
    """``with span(key):`` adds the block's seconds to the open stage's
    ``timings[key]``; ``.seconds`` holds them after the block. With
    ``nest=False`` the spans inside the block count as its parent's
    children, and the block is not one."""

    __slots__ = ("key", "nest", "seconds", "_trace", "_token", "_direct",
                 "_t0", "_rf")

    def __init__(self, key: str, nest: bool = True):
        self.key = key
        self.nest = nest
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._trace = self._token = None
        self._direct = False
        cur = _OPEN.get()
        if cur is not None:
            trace, keys = cur
            if self.key not in keys:
                self._trace = trace
                if self.nest:
                    self._direct = (not keys and
                                    threading.get_ident() == trace.thread)
                    self._token = _OPEN.set((trace, keys + (self.key,)))
            self._rf = _range(trace.name, self.key)
        else:
            self._rf = _range(self.key)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self.seconds = time.perf_counter() - self._t0
        if self._trace is not None:
            if self._token is not None:
                _OPEN.reset(self._token)
            self._trace.add(self.key, self.seconds)
            if self._direct:
                self._trace.direct += self.seconds


def add(key: str, value: float) -> None:
    """Add ``value`` to the open stage's ``timings[key]``; nothing outside
    a stage."""
    cur = _OPEN.get()
    if cur is not None:
        cur[0].add(key, value)


@contextlib.contextmanager
def stage_timer(name: str, fmt: str | None = None,
                verbose: bool = True) -> Iterator[None]:
    """``span(name)``; optionally print ``fmt % secs`` after the block."""
    with span(name) as s:
        yield
    if verbose and fmt:
        print(fmt % s.seconds)


@contextlib.contextmanager
def host_wait(device, n: int = 1) -> Iterator[None]:
    """A block in which the host waits on ``device`` ``n`` times (a copy
    to the card, a synchronising op): counted in ``host_syncs`` when
    ``device`` is a CUDA device, its seconds in ``host_wait`` on the
    stage's own thread."""
    cur = _OPEN.get()
    if cur is not None:
        trace = cur[0]
        trace.add("host_syncs",
                  n if str(device).split(":")[0] == "cuda" else 0)
        if threading.get_ident() != trace.thread:
            yield
            return
    with span("host_wait"):
        yield


def to_host(t):
    """The tensor ``t`` as a numpy array: on a card, one host wait."""
    with host_wait(t.device):
        return t.cpu().numpy()


def to_device(t, device):
    """``t.to(device)``: a copy of a host tensor to a card is one host
    wait (from pageable memory it returns once the card has the bytes)."""
    if t.is_cuda or not t.numel():
        return t.to(device)
    with host_wait(device):
        return t.to(device)
