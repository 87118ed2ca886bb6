"""The traced run's reduction: device busy time as the union of the
device's intervals, its idle gaps named by the innermost span around
them, and device time by operation."""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

SPAN = "scanbench."
WINDOW = SPAN + "window"


def _events(prof) -> Tuple[list, list]:
    """(device intervals (start, end, name), host spans (start, end,
    name)) in microseconds of the profiler's clock."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end, e.name)
        if e.name.startswith(SPAN):
            # the profiler mirrors each span onto the device's timeline
            if e.device_type == DeviceType.CPU:
                host.append(iv)
        elif e.device_type == DeviceType.CUDA:
            dev.append(iv)
    return dev, host


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].strip() or "unnamed"


def _union(ivs: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def reduce(prof, top: int = 10) -> Dict[str, object]:
    """busy_s, window_s, kernel_s (device seconds by operation name),
    and the breakdown's device_ops and idle_gaps."""
    dev, host = _events(prof)
    windows = [h for h in host if h[2] == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1, _ = windows[0]
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    if not dev:
        raise RuntimeError("the trace holds no device operation in the "
                           "window")
    busy = _union([(s, e) for s, e, _ in dev])
    by_op: Dict[str, float] = collections.defaultdict(float)
    for s, e, n in dev:
        by_op[_short(n)] += (e - s) * 1e-6
    spans = [h for h in host if h[2] != WINDOW]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        around = [h for h in spans if h[0] <= mid <= h[1]]
        name = max(around, key=lambda h: h[0])[2] if around else "harness"
        gaps.append([name, (e - s) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernel_s": dict(by_op),
        "breakdown": {"device_ops": [[n, t] for n, t in ops[:top]],
                      "idle_gaps": gaps[:top]},
    }
