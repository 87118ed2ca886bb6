"""Profile one rescan (pose_proposal -> segment_transfer) of the PyTorch
port on the card under torch.profiler, with the program's spans as
profiler ranges (rescan_tpu_torch/utils/timing.py): device busy time as
the union of the device's intervals, the idle gaps between them each named
by the program span that covers most of it, device time per operation,
and the stages' seconds by span.

    python tools/profile_torch_port.py [--scene bench|small] [--out DIR]
        [--turns N]

Needs a CUDA device and raises without one.
The sequence (rescan_tpu_torch.sequences) is written and bootstrapped by
a first ``driver.run_sequence``, which also builds the kernels; the
profiled run then repeats the rescan from the bootstrap database,
reloading the prior from its .rsdb as the stage CLIs do. A gap is named by the innermost span of
the stages' own thread that covers at least half of it, with the spans
around it (its call site: ``segment_transfer: total > augment > aug_merge
> levels``) and the seconds of the gap under each span directly inside
it. ``--turns N``: then N pairs of rescans under the profiler,
ranges off and on in turns (off, on, on, off, ...), for what the ranges
cost a rescan. Prints one JSON line; the chrome trace goes to
DIR/trace.json when --out is given.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

PREFIX = "rescan."
STAGES = (PREFIX + "pose_proposal", PREFIX + "segment_transfer")


def _union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].strip() or "unnamed"


def reduce(events, top: int = 12) -> dict:
    """Busy and idle time of the device over the stages' root spans, its
    longest idle gaps by program span, device seconds by operation, and
    the number of the program's ranges on the stages' thread, from a
    profile's kineto events (``prof.profiler.kineto_results``)."""
    from torch.autograd import DeviceType
    evs = [(e.start_ns(), e.end_ns(), e.name(), e.device_type(),
            e.start_thread_id(), e.is_user_annotation()) for e in events]
    spans = [e for e in evs if e[3] == DeviceType.CPU
             and e[2].startswith(PREFIX)]
    roots = [e for e in spans if e[2] in STAGES]
    if not roots:
        raise RuntimeError("the trace holds no stage span: are the "
                           "program's ranges on?")
    spans = [e[:3] for e in spans if e[4] == roots[0][4]]
    w0 = min(e[0] for e in roots)
    w1 = max(e[1] for e in roots)
    # the device's operations, without the profiler's copies of the ranges
    dev = [(max(s, w0), min(e, w1), n) for s, e, n, kind, _, note in evs
           if kind == DeviceType.CUDA and not note
           and not n.startswith(PREFIX) and e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in dev])
    by_op = collections.defaultdict(float)
    for s, e, n in dev:
        by_op[_short(n)] += (e - s) * 1e-9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((s, e) for s, e in zip(edges[0::2], edges[1::2])
                   if e > s), key=lambda g: g[0] - g[1])[:top]
    busy_s = sum(e - s for s, e in busy) * 1e-9
    window_s = (w1 - w0) * 1e-9
    return {"window_s": window_s, "ranges": len(spans),
            "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / window_s,
            "idle_gaps": [{"s": (e - s) * 1e-9, **_site(spans, s, e)}
                          for s, e in gaps],
            "device_s_by_op": dict(sorted(by_op.items(),
                                          key=lambda kv: -kv[1])[:top])}


def _site(spans, s: float, e: float) -> dict:
    """The innermost span covering at least half of [s, e], with the spans
    around it ("stage: outer > ... > inner"), and the seconds of the gap
    that each span directly under it covers."""
    half = 0.5 * (e - s)
    cover = [h for h in spans if min(h[1], e) - max(h[0], s) >= half]
    if not cover:
        return {"span": "outside the stages"}
    inner = max(cover, key=lambda h: (h[0], -h[1]))
    path = sorted((h for h in spans if h[0] <= inner[0] and h[1] >= inner[1]),
                  key=lambda h: (h[0], -h[1]))
    stage = path[0][2][len(PREFIX):]
    cut = len(PREFIX) + len(stage) + 1
    keys = [h[2][cut:] for h in path[1:]]
    under = [h for h in spans if h != inner and inner[0] <= h[0]
             and h[1] <= inner[1]]
    within = collections.defaultdict(float)
    for h in under:
        if not any(o != h and o[0] <= h[0] and h[1] <= o[1] for o in under):
            within[h[2][cut:]] += max(min(h[1], e) - max(h[0], s), 0) * 1e-9
    return {"span": stage + (": " + " > ".join(keys) if keys else ""),
            "within": {k: v for k, v in within.items() if v > 0}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("bench", "small"), default="bench")
    ap.add_argument("--out", default=None)
    ap.add_argument("--turns", type=int, default=0)
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out) if args.out else None

    from rescan_tpu_torch import resolve_device, sequences
    from rescan_tpu_torch.ops import gnn, pairsum
    from rescan_tpu_torch.pipeline import (driver, pose_proposal,
                                           segment_transfer)
    from rescan_tpu_torch.utils import timing

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    write = (sequences.write_bench_sequence if args.scene == "bench"
             else sequences.write_small_sequence)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as work:
        class_file = write(work)
        os.chdir(work)
        t0 = time.perf_counter()
        driver.run_sequence(sequences.SEQ_NAME, class_file, device=dev)
        first = time.perf_counter() - t0
        seq = sequences.SEQ_NAME

        def rescan(ranges: bool):
            timing.profiler_ranges(ranges)
            try:
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    db = pose_proposal.run(
                        os.path.join(seq, "scan_000.rsdb"),
                        os.path.join(seq, "gt_segmentation", "scan_001.ply"),
                        os.path.join(seq, "prof_pp.rsdb"), device=dev)
                    db = segment_transfer.run(
                        os.path.join(seq, "prof_pp.rsdb"),
                        os.path.join(seq, "prof.rsdb"), db=db, device=dev)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                timing.profiler_ranges(False)
            return prof, db, wall

        gnn.reset_counts()
        pairsum.reset_counts()
        prof, db, wall = rescan(True)
        launches = dict(gnn.LAUNCHES, **pairsum.LAUNCHES)
        if out:
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out, "trace.json"))
        profile = reduce(prof.profiler.kineto_results.events())
        del prof
        turns = []
        for k in range(args.turns):
            for ranges in ((False, True) if k % 2 == 0 else (True, False)):
                turns.append({"ranges": ranges,
                              "rescan_s": rescan(ranges)[2]})
    print(json.dumps({
        "scene": args.scene, "device": str(dev), "card": card,
        "first_run_s": first, "rescan_wall_s": wall, **profile,
        "kernel_launches": launches, "turns": turns,
        "pose_proposal": db.last_pose_proposal_timings,
        "segment_transfer": db.last_segment_transfer_timings,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
