"""The LoD levels on the card (ops/levels.py, ops/csrc/levels.cu) against
the native pass, on bench.py's scan.

    python tools/time_torch_port_levels.py [--reps N] [--rescan]

Writes bench.py's two scans (resolution 16) into a temporary directory,
loads the first one's level 0, and times, host clock around each call
(a card call ends in its copy of the indices to the host), median of
``--reps`` after a warm-up: the native pass at each voxel, the card's
whole pyramid (every level in one call) and each level alone, with its
rounds; then one pyramid under torch.profiler: the device time of each
of the library's kernels and their launches. Every card result is held
to the native pass index for index first. The byte bound is the
positions read once (12 B a point) and the indices written once (4 B a
kept point) at 3.35 TB/s. ``--rescan`` also runs the bench rescan on the
card as the benchmark runs it (the seg2rsdb bootstrap, a warm-up rescan,
then one with the prior reloaded from its .rsdb) and gives its card
calls, their rounds and seconds, and the stages' ``levels`` seconds.
Prints one JSON line (the card's name and power limit beside the times).
Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BYTES_PER_SECOND = 3.35e12


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--id=0",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip()


def median_s(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def kernel_times(fn, torch) -> dict:
    """Device ms and launches of each kernel ``fn`` runs, by name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        if dev_us and "kernel" in e.key:
            name = e.key.replace("(anonymous namespace)::", "")
            out[name.split("(")[0].replace("void ", "")] = {
                "ms": dev_us / 1e3, "launches": e.count}
    return out


class Phases:
    """``lib`` with each entry point's call timed up to the end of its
    kernels (a synchronize after it), and levels' copies timed."""

    def __init__(self, lib, torch):
        self.lib, self.torch, self.ms = lib, torch, {}

    def _add(self, key, t0):
        self.torch.cuda.synchronize()
        self.ms[key] = self.ms.get(key, 0.0) + 1e3 * (
            time.perf_counter() - t0)

    def __getattr__(self, name):
        f = getattr(self.lib, name)

        def call(*a):
            t0 = time.perf_counter()
            rc = f(*a)
            self._add(name, t0)
            return rc
        return call

    def copy(self, fn, key):
        def call(*a):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            self._add(key, t0)
            return out
        return call


def phase_ms(levels, pts, voxels, dev, torch) -> dict:
    """One pyramid's host milliseconds by phase: the upload, the grid, the
    rounds (with their reads of the counts), the output, the copy back,
    and the rest (the host's own work between them)."""
    import types
    ph = Phases(levels.load_library(), torch)
    real = levels.timing
    levels.timing = types.SimpleNamespace(
        to_device=ph.copy(real.to_device, "to_device"),
        to_host=ph.copy(real.to_host, "to_host"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            levels.run(ph, pts, voxels, dev,
                       torch.cuda.current_stream(dev).cuda_stream)
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        levels.timing = real
    ph.ms["total"] = total
    ph.ms["rest"] = total - sum(v for k, v in ph.ms.items() if k != "total")
    return ph.ms


def copy_ms(pts, dev, torch, reps: int = 5) -> dict:
    """Milliseconds of the positions' copy to the card from pageable and
    from pinned memory (the pinning's host copy counted apart)."""
    t = torch.from_numpy(pts)
    pin = t.pin_memory()

    def up(src, **k):
        def f():
            src.to(dev, **k)
            torch.cuda.synchronize()
        return f
    return {"bytes": t.numel() * 4,
            "pageable_ms": 1e3 * median_s(up(t), reps),
            "pinned_ms": 1e3 * median_s(up(pin, non_blocking=True), reps),
            "pin_ms": 1e3 * median_s(lambda: t.pin_memory(), reps)}


def rescan_levels(torch, scans, class_file, work) -> dict:
    from rescan_tpu_torch.core import pointcloud
    from rescan_tpu_torch.ops import levels
    from rescan_tpu_torch.pipeline import (pose_proposal, seg2rsdb,
                                           segment_transfer)
    dev = torch.device("cuda", 0)
    prior = os.path.join(work, "prior.rsdb")

    def rescan(name):
        pp = os.path.join(work, name + "_pp.rsdb")
        db = pose_proposal.run(prior, scans[1], pp, devices=[dev])
        return segment_transfer.run(pp, os.path.join(work, name + ".rsdb"),
                                    db=db, devices=[dev])

    calls = []
    compute = pointcloud.PointCloud.compute_levels

    def timed(self, *a, **k):
        t0 = time.perf_counter()
        compute(self, *a, **k)
        calls.append({"points": self.n_pts(0),
                      "seconds": time.perf_counter() - t0,
                      "rounds": list(levels.ROUNDS)})

    with contextlib.redirect_stdout(io.StringIO()):
        seg2rsdb.run(scans[0], class_file, prior)
        rescan("warm")
        torch.cuda.synchronize()
        levels.reset_counts()
        pointcloud.PointCloud.compute_levels = timed
        try:
            t0 = time.perf_counter()
            db = rescan("again")
            seconds = time.perf_counter() - t0
        finally:
            pointcloud.PointCloud.compute_levels = compute
    return {"rescan_s": seconds, "calls": calls,
            "launches": levels.LAUNCHES["poisson_levels"],
            "plain_calls": levels.PLAIN_CALLS["poisson_levels"],
            "levels_s": {"pose_proposal":
                         db.last_pose_proposal_timings.get("levels", 0.0),
                         "segment_transfer":
                         db.last_segment_transfer_timings.get("levels",
                                                              0.0)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rescan", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_port_levels: no CUDA device")
    from rescan_tpu_torch import config, sequences
    from rescan_tpu_torch.core import native
    from rescan_tpu_torch.core.pointcloud import PointCloud
    from rescan_tpu_torch.ops import levels

    dev = torch.device("cuda", 0)
    voxels = config.LEVEL_VOXEL_SIZES[1:]
    out = {"card": card_line(), "voxels": list(voxels)}
    with tempfile.TemporaryDirectory() as work:
        class_file = sequences.write_bench_sequence(work)
        gt = os.path.join(work, sequences.SEQ_NAME, "gt_segmentation")
        scans = [os.path.join(gt, f"scan_{i:03d}.ply") for i in (0, 1)]
        pts = PointCloud.from_ply(scans[0], compute_levels=False).pos(0)
        n = len(pts)
        out["points"] = n

        t0 = time.perf_counter()
        levels.load_library()
        out["build_s"] = time.perf_counter() - t0
        out["ptxas"] = [ln.strip() for ln in levels.BUILD_LOG.splitlines()
                        if "registers" in ln or "spill" in ln]

        want = [native.poisson_subsample(pts, v) for v in voxels]
        got = levels.poisson_levels(pts, voxels, dev)
        for v, g, w in zip(voxels, got, want):
            if not np.array_equal(g, w):
                raise SystemExit(f"time_torch_port_levels: voxel {v} "
                                 f"differs from the native pass")
        out["kept"] = [len(w) for w in want]
        out["native_ms"] = [1e3 * median_s(
            lambda v=v: native.poisson_subsample(pts, v), args.reps)
            for v in voxels]
        out["pyramid_ms"] = 1e3 * median_s(
            lambda: levels.poisson_levels(pts, voxels, dev), args.reps)
        out["pyramid_rounds"] = list(levels.ROUNDS)
        per = []
        for v in voxels:
            ms = 1e3 * median_s(lambda v=v: levels.poisson_levels(
                pts, [v], dev), args.reps)
            per.append({"voxel": v, "ms": ms, "rounds": levels.ROUNDS[0]})
        out["level_alone"] = per
        out["kernels"] = kernel_times(
            lambda: levels.poisson_levels(pts, voxels, dev), torch)
        out["device_ms"] = sum(k["ms"] for k in out["kernels"].values())
        out["phases_ms"] = phase_ms(levels, pts, voxels, dev, torch)
        out["copy"] = copy_ms(pts, dev, torch)
        out["bound_ms"] = 1e3 * (12 * n + 4 * sum(out["kept"])) \
            / BYTES_PER_SECOND
        if args.rescan:
            out["rescan"] = rescan_levels(torch, scans, class_file, work)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
