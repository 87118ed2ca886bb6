"""Seconds per substage of the port's bench rescan on the card, for the
checkout this file sits in or another one, so that two versions of the
port can be timed in turns on the same card.

    python tools/time_torch_port_stages.py [--package-root DIR] [--runs N]

``--package-root``: the directory holding the ``rescan_tpu_torch`` to time
(default: this checkout). Writes bench.py's 2-scan sequence
(``rescan_tpu_torch.sequences.write_bench_sequence``) afresh for each run,
runs the driver on ``cuda:0`` once to build the kernels and warm up, then
``--runs`` more times, and prints one JSON line: the package root, the
card (name and power limit, as nvidia-smi gives them) and every timed
run's pose_proposal and segment_transfer substages in seconds. Needs a
CUDA device and raises without one.

``--icp-split``: also split one ``icp_refine`` call of the bench rescan
(the pose-proposal stage's ``icp_align_indexed``, its inputs kept from
the warm-up run) into the step's parts, replayed on the same inputs:
``k2`` (the gated nearest-neighbour search), ``sums`` (the four rounds of
per-pair sums), ``tail`` (everything after the fourth round), ``head``
(the rest of the step: the transforms, weights, rejection and the
operands of the sums, where the ``icp_head`` kernel's launches fall) and
``loop`` (outside the steps: the start mask, each iteration's
``bool(active.any())`` wait and the annealing). One replay gives host
wall milliseconds per iteration by part (host clock at the part
boundaries, no synchronisation added) and, where the package counts
them, the ``icp_head`` launches per iteration; a second, under
torch.profiler with a range per part, gives device-busy milliseconds and
device operations (kernels and copies) per iteration, in all and by
part; a third, under ``torch.cuda.set_sync_debug_mode("warn")``, counts
the host's waits on the card (the synchronising calls PyTorch warns of:
a blocking copy, ``item()``, a synchronise) per iteration, in all and by
part. Works on any version of the port that has ``ops.icp._icp_step``,
``ops.search.nearest_gated`` and ``ops.pairsum.sums``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=ROOT)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--icp-split", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_port_stages: no CUDA device")
    from rescan_tpu_torch import sequences
    from rescan_tpu_torch.pipeline import driver

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    runs = []
    captured = []
    with tempfile.TemporaryDirectory() as work:
        for k in range(args.runs + 1):
            undo = _capture_icp_refine(captured) if args.icp_split and not k \
                else None
            seq_root = os.path.join(work, f"bench_{k}")
            class_file = sequences.write_bench_sequence(seq_root)
            profiles = []
            cwd = os.getcwd()
            os.chdir(seq_root)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    driver.run_sequence(sequences.SEQ_NAME, class_file,
                                        profiles=profiles,
                                        devices=[torch.device("cuda", 0)])
            finally:
                os.chdir(cwd)
                if undo:
                    undo()
            torch.cuda.synchronize()
            if k:
                p = profiles[0]
                runs.append({s: {n: round(v, 4) for n, v in p[s].items()}
                             for s in ("pose_proposal", "segment_transfer")})
    out = {"package_root": root, "card": card, "runs": runs}
    if args.icp_split:
        out["icp_split"] = icp_split(*captured[0])
    print(json.dumps(out))
    return 0


def _capture_icp_refine(captured: list):
    """Keep a copy of the inputs of the first ``icp_align_indexed`` call
    (the pose-proposal stage's icp_refine); returns the undo."""
    from rescan_tpu_torch.ops import icp
    real = icp.icp_align_indexed

    def keep(*a, **k):
        if not captured:
            captured.append((tuple(v.clone() if hasattr(v, "clone") else v
                                   for v in a), dict(k)))
        return real(*a, **k)

    icp.icp_align_indexed = keep
    return lambda: setattr(icp, "icp_align_indexed", real)


PARTS = ("head", "k2", "sums", "tail")


def _instrumented(acc: dict, mark):
    """Wrap the step, the search and the sums so that ``acc`` gathers the
    host seconds of each part and ``mark(name)`` opens a range around it
    (``mark`` returns a context manager). The tail is the step after its
    fourth round of sums. Returns the undo."""
    from rescan_tpu_torch.ops import icp, pairsum, search
    real = (icp._icp_step, search.nearest_gated, pairsum.sums)
    state = {"round": 0, "tail": None, "in_step": False}

    def nn(*a, **k):
        t0 = time.perf_counter()
        with mark("k2"):
            out = real[1](*a, **k)
        acc["k2"] += time.perf_counter() - t0
        return out

    def sums(x, spec):
        if not state["in_step"]:                # the start mask: the loop's
            return real[2](x, spec)
        t0 = time.perf_counter()
        with mark("sums"):
            out = real[2](x, spec)
        t1 = time.perf_counter()
        acc["sums"] += t1 - t0
        state["round"] += 1
        if state["round"] == 4:
            state["tail"] = (t1, mark("tail"))
            state["tail"][1].__enter__()
        return out

    def step(*a, **k):
        state.update(round=0, tail=None, in_step=True)
        t0 = time.perf_counter()
        with mark("step"):
            out = real[0](*a, **k)
            t1, rng = state["tail"]
            rng.__exit__(None, None, None)
        t2 = time.perf_counter()
        state["in_step"] = False
        acc["tail"] += t2 - t1
        acc["step"] += t2 - t0
        acc["iterations"] += 1
        return out

    icp._icp_step, search.nearest_gated, pairsum.sums = step, nn, sums

    def undo():
        icp._icp_step, search.nearest_gated, pairsum.sums = real
    return undo


def _replay(call, mark) -> dict:
    """One instrumented run of ``call``; host seconds by part."""
    import torch
    acc = dict.fromkeys(("step", "k2", "sums", "tail", "iterations"), 0)
    undo = _instrumented(acc, mark)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        acc["wall"] = time.perf_counter() - t0
    finally:
        undo()
    acc["head"] = acc["step"] - acc["k2"] - acc["sums"] - acc["tail"]
    acc["loop"] = acc["wall"] - acc["step"]
    return acc


# the host's calls that put work on the card: kernel launches, copies, fills
_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                 "cuMemcpy", "cuMemset")


def _device_split(events, prefix: str) -> dict:
    """Device operations and device milliseconds in all and by part from
    the profiler's raw events: the card's kernels, copies and fills (not
    the ranges' own device spans); an operation belongs to the part whose
    range holds the host call that launched it (found by correlation id)
    and, as a count, the part whose range holds a launch call."""
    import torch
    ranges, launches, device = [], [], []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(prefix):
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               name[len(prefix):]))
            elif name.startswith(_LAUNCH_CALLS):
                launches.append(e)
        elif not name.startswith(prefix):
            device.append(e)

    def part_of(t):
        # the innermost range holding t: the step holds the other three
        inner = [r for r in ranges if r[0] <= t <= r[1]]
        inner = [r for r in inner if r[2] != "step"] or inner
        return inner[0][2] if inner else "loop"

    by_corr = {}
    ops = dict.fromkeys(PARTS + ("step", "loop"), 0)
    for e in launches:
        part = part_of(e.start_ns())
        ops[part] += 1
        by_corr[e.correlation_id()] = part
    ms = dict.fromkeys(PARTS + ("step", "loop", "unattributed"), 0.0)
    for e in device:
        part = by_corr.get(e.correlation_id(),
                           by_corr.get(e.linked_correlation_id(),
                                       "unattributed"))
        ms[part] += e.duration_ns() / 1e6
    ops["head"] += ops.pop("step")
    ms["head"] += ms.pop("step")
    return {"busy_ms": sum(e.duration_ns() for e in device) / 1e6,
            "ops": len(device), "launch_calls": len(launches),
            "ops_by_part": ops, "ms_by_part": ms}


class _Waits:
    """The host's waits on the card by part: a stack of the parts the host
    is in (``mark``), and each synchronising call that PyTorch warns of
    under sync debug mode "warn" given to the innermost one (the step
    holds the other three; its own share is the head's)."""

    def __init__(self):
        self.stack = []
        self.count = dict.fromkeys(PARTS + ("loop",), 0)

    @contextlib.contextmanager
    def mark(self, name):
        self.stack.append(name)
        try:
            yield
        finally:
            self.stack.remove(name)

    def show(self, message, *_):
        if "synchroniz" not in str(message):
            return
        inner = [p for p in self.stack if p != "step"]
        self.count[inner[-1] if inner else
                   "head" if self.stack else "loop"] += 1


def _count_waits(call) -> dict:
    """One instrumented run of ``call`` under sync debug mode "warn" (set
    around the call alone): the waits by part (``_Waits``)."""
    import torch
    waits = _Waits()
    acc = dict.fromkeys(("step", "k2", "sums", "tail", "iterations"), 0)
    undo = _instrumented(acc, waits.mark)
    try:
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = waits.show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        undo()
    return waits.count


def icp_split(args, kwargs) -> dict:
    """The icp_refine call's split by part (see the module docstring)."""
    import torch
    from rescan_tpu_torch.ops import icp, pairsum

    def call():
        return icp.icp_align_indexed(*args, **kwargs)

    call()                                     # warm
    heads = pairsum.LAUNCHES.get("icp_head", 0)
    host = _replay(call, lambda name: contextlib.nullcontext())
    heads = pairsum.LAUNCHES.get("icp_head", 0) - heads
    n = host["iterations"]
    prefix = "icp_split::"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_host = _replay(call, lambda name: torch.profiler.record_function(
            prefix + name))
    split = _device_split(prof.profiler.kineto_results.events(), prefix)
    waits = _count_waits(call)
    return {
        "pairs": int(args[3].shape[0]), "iterations": n,
        "wall_ms_per_iter": host["wall"] * 1e3 / n,
        "host_ms_per_iter": {p: host[p] * 1e3 / n
                             for p in PARTS + ("loop",)},
        "device_busy_ms_per_iter": split["busy_ms"] / n,
        "device_ops_per_iter": split["ops"] / n,
        "launch_calls_per_iter": split["launch_calls"] / n,
        "device_ms_per_iter_by_part": {p: v / n for p, v in
                                       split["ms_by_part"].items()},
        "device_ops_per_iter_by_part": {p: v / n for p, v in
                                        split["ops_by_part"].items()},
        "icp_head_launches_per_iter": heads / n,
        "waits_per_iter": sum(waits.values()) / n,
        "waits_per_iter_by_part": {p: v / n for p, v in waits.items()},
        "profiled_wall_ms_per_iter": prof_host["wall"] * 1e3 / n,
        "profiled_iterations": prof_host["iterations"]}


if __name__ == "__main__":
    sys.exit(main())
