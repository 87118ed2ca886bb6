"""One run of one cell: set-up, the measured window of rescans, the
traced reduction, the check against the reference, the result line.

Everything a cell needs is found by name: its entry in BENCHMARK.json,
its configuration file, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and, for every per-layer metric it reports,
``metrics/<name>.py`` (a ``read(record)`` that returns the value or
None).
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rescan_tpu")
SPAN = "scanbench."


# --- the cell, found by name ----------------------------------------------

def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The workload's entry with its configuration, traffic, limits and
    the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    folder = os.path.join(root, bench["paths"][0])
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = found[0]
    (cfg,) = [c for c in bench["configs"] if c["name"] == cell["config"]]

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and m["moves"] in names]
    return {
        "workload": cell,
        "folder": folder,
        "run_seconds": bench["run_seconds"],
        "config": _json(os.path.join(root, cfg["file"])),
        "traffic": _json(os.path.join(folder, "traffic",
                                      cell["traffic"] + ".json")),
        "limits": _json(os.path.join(folder, "limits", workload + ".json")),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def reader(name: str, folder: str = HERE):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(folder, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "scanbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- the system under test ---------------------------------------------------

class Program:
    """The port's rescan on one device, with the benchmark's spans around
    the calls into its layers, each gated nearest-neighbour launch's
    shape recorded, and each ICP call's starting and final poses kept
    (two copies of a few kilobytes from the card a call)."""

    def __init__(self, device):
        import torch
        from rescan_tpu_torch.core import native, pointcloud
        from rescan_tpu_torch.ops import gnn
        from rescan_tpu_torch.pipeline import (pose_proposal, seg2rsdb,
                                               segment_transfer)
        self.torch = torch
        self.device = torch.device(device)
        self.stages = (seg2rsdb, pose_proposal, segment_transfer)
        self.launches: List[tuple] = []
        self._undo = []
        self._wrap(pointcloud.PointCloud, "compute_levels", "compute_levels")
        self._wrap(native, "abswap", "abswap")
        self._wrap(native, "smooth_graph", "smooth_graph")

        def shape(slab, q_pos, q_nrm, radius, cos_gate, use_abs, want_idx):
            if slab.n_valid:
                self.launches.append(("nearest_gated" if want_idx else
                                      "gated_min", int(q_pos.shape[0]),
                                      int(slab.n_valid)))
        self._wrap(gnn, "_launch", "gnn", shape)
        self._record_icp()

    def _record_icp(self):
        """Keep each ICP call's starting poses beside the poses it returns,
        so that the check can follow the ICP from the same hypotheses."""
        from rescan_tpu_torch.ops import icp
        align = icp.icp_align_indexed
        calls = self.icp_calls = []

        @functools.wraps(align)
        def recorded(*a, **k):
            t_init = a[6] if len(a) > 6 else k["T_init"]
            start = t_init.detach().cpu().numpy()
            out = align(*a, **k)
            calls.append((start, out[0].detach().cpu().numpy()))
            return out
        icp.icp_align_indexed = recorded
        self._undo.append((icp, "icp_align_indexed", align))

    def _wrap(self, owner, attr, name, before=None):
        fn = getattr(owner, attr)
        rf = self.torch.profiler.record_function

        @functools.wraps(fn)
        def wrapped(*a, **k):
            if before is not None:
                before(*a, **k)
            with rf(SPAN + name):
                return fn(*a, **k)
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, fn))

    def close(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)

    def counters(self) -> dict:
        from rescan_tpu_torch.ops import dense_nn, gnn, hashgrid, pairsum
        return {m.__name__.rsplit(".", 1)[1]: {"launches": dict(m.LAUNCHES),
                                               "plain_calls":
                                               dict(m.PLAIN_CALLS)}
                for m in (gnn, pairsum, hashgrid, dense_nn)}

    def bootstrap(self, scan: str, classes: str, out: str):
        with _quiet():
            self.stages[0].run(scan, classes, out)

    def rescan(self, prior: str, scan: str, out_dir: str):
        """pose_proposal then segment_transfer, as the stage CLIs chain
        them (the prior reloaded from its file), on this device alone."""
        rf = self.torch.profiler.record_function
        devs = [self.device]
        pp = os.path.join(out_dir, "scan_pp.rsdb")
        self.icp_calls.clear()
        with _quiet(), rf(SPAN + "rescan"):
            with rf(SPAN + "pose_proposal"):
                db = self.stages[1].run(prior, scan, pp, devices=devs)
            with rf(SPAN + "segment_transfer"):
                db = self.stages[2].run(pp, os.path.join(out_dir, "scan.rsdb"),
                                        db=db, devices=devs)
            if self.device.type == "cuda":
                self.torch.cuda.synchronize(self.device)
        return db


@contextlib.contextmanager
def _quiet():
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def outputs(db, icp_calls) -> dict:
    """What a rescan produced: each prior object's proposals (best first),
    the hypothesis from which the ICP reached each (None where no ICP call
    of the rescan returned that pose), and the segmented scan's level-1
    points and labels."""
    start_of = {}
    for start, end in icp_calls:
        for t0, t1 in zip(start, end):
            start_of.setdefault(np.asarray(t1, np.float32).tobytes(), t0)
    props, starts = {}, {}
    for i in range(len(db.proposed_poses[-1])):
        poses = db.proposed_poses[-1][i]
        scores = db.proposed_scores[-1][i]
        if poses is not None and len(poses):
            poses = np.asarray(poses, np.float32).reshape(-1, 4, 4)
            props[i] = (poses.astype(np.float64),
                        np.asarray(scores, np.float64).reshape(-1))
            starts[i] = [start_of.get(p.tobytes()) for p in poses]
    lvl = db.scenes[-1].cloud.levels[1]
    return {"proposals": props, "icp_starts": starts,
            "labels": {k: np.array(lvl[k]) for k in
                       ("positions", "class_ids", "instance_ids")}}


def _bytes_under(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


# --- one run -----------------------------------------------------------------

def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        work: str, t0: float) -> dict:
    """Set up, measure, check. Returns the result line's fields."""
    import torch
    from . import scenes, trace as tracing
    from .reference import check

    cfg, traffic = cell["config"], cell["traffic"]
    room0 = scenes.room_of(cfg)
    pool_rooms = scenes.draw_pool(room0, traffic, seed)
    res = cfg["mesh_resolution"]
    classes = os.path.join(work, "classes.txt")
    scenes.write_class_file(classes)

    def scan(name, room):
        path = os.path.join(work, name + ".ply")
        scenes.write_ply(path, scenes.scene_mesh(room, res))
        return path

    prog = Program(device)
    try:
        prior = os.path.join(work, "prior_0.rsdb")
        prog.bootstrap(scan("scan_000", room0), classes, prior)
        pool = [scan(f"pool_{j}", r) for j, r in enumerate(pool_rooms)]
        dirs = [os.path.join(work, f"out_{j}") for j in range(len(pool))]
        for d in dirs:
            os.makedirs(d)
        prog.rescan(prior, pool[0], dirs[0])          # the warm-up
        written = _bytes_under(dirs[0])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        prog.launches.clear()
        before = prog.counters()
        setup_s = time.perf_counter() - t0

        last, calls = {}, {}
        timings = []
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            with torch.profiler.record_function(tracing.WINDOW):
                tw = time.perf_counter()
                n = 0
                while True:
                    j = n % len(pool)
                    t1 = time.perf_counter()
                    last[j] = prog.rescan(prior, pool[j], dirs[j])
                    calls[j] = list(prog.icp_calls)
                    timings.append({
                        "seconds": time.perf_counter() - t1,
                        "pose_proposal": dict(
                            last[j].last_pose_proposal_timings),
                        "segment_transfer": dict(
                            last[j].last_segment_transfer_timings)})
                    n += 1
                    # whole passes over the pool, so that every run's
                    # window does the same work
                    if n % len(pool) == 0 and \
                            time.perf_counter() - tw >= seconds:
                        break
                window = time.perf_counter() - tw
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        peak = (int(torch.cuda.max_memory_allocated(device))
                if device.type == "cuda" else 0)
        after = prog.counters()
        launches = list(prog.launches)
        outs = {j: outputs(db, calls[j]) for j, db in last.items()}
    finally:
        prog.close()
    del last, calls, prog
    if device.type == "cuda":
        torch.cuda.empty_cache()

    record = {"rescans": timings, "launches": launches, "n_rescans": n,
              "window_s": window}
    if prof is not None:
        record.update(tracing.reduce(prof))
        del prof

    # the check, once the window has closed and the program's state is freed
    t_check = time.perf_counter()
    objs = check.objects_of(scenes.scene_mesh(room0, res))
    twins = scenes.twin_groups(room0)
    judged = [{"room": pool_rooms[j], "twins": twins,
               "mesh": scenes.scene_mesh(pool_rooms[j], res), **outs[j]}
              for j in sorted(outs)]
    limits = cell["limits"]
    per = [check.judge([r], objs, seed, traffic["proposal_sample"])
           for r in judged]
    nums = {k: max(p[k] for p in per) for k in limits}
    failed = sum(any(p[k] > limits[k] for k in limits) for p in per)
    check_s = time.perf_counter() - t_check
    return {"judged": judged, "objects": objs, "setup_s": setup_s,
            "rescan_s": window / n, "record": record, "peak": peak,
            "numbers": nums, "failed": failed, "attempted": n,
            "written": written, "check_s": check_s,
            "counters": {m: {k: {n_: after[m][k][n_] - before[m][k][n_]
                                 for n_ in after[m][k]}
                             for k in after[m]} for m in after}}


def main(args, t0: float) -> int:
    cell = load_cell(args.workload)
    chips = cell["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"scanbench: the cell needs {chips} CUDA card(s); found {have}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"scanbench: {torch.cuda.get_device_name(0)}, power limit "
          f"{power_limit()}", flush=True)
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = tempfile.mkdtemp(prefix="scanbench-", dir=base)
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace), dev, work,
                  t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"scanbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3

    print(f"scanbench: bytes written per rescan {out['written']}")
    print(f"scanbench: the check took {out['check_s']!r} s")
    print("scanbench: seconds of each rescan in the window "
          + " ".join(repr(r["seconds"]) for r in out["record"]["rescans"]))
    if args.trace:
        print("scanbench: counters over the window "
              + json.dumps(out["counters"], sort_keys=True))
    line = result_line(cell, out, bool(args.trace),
                       torch.cuda.get_device_name(0))
    limits = cell["limits"]
    for k in limits:
        print(f"{k} {out['numbers'][k]!r} limit {limits[k]!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def result_line(cell: dict, out: dict, trace: bool, kind: str) -> dict:
    """The last line of a run: with ``trace`` the cell's per-layer metrics
    that found something to read, else its end-to-end metrics; each
    number compared beside its limit under ``checks``, last."""
    rec = out["record"]
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = reader(m["name"], cell["folder"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = {"setup_s": out["setup_s"], "rescan_s": out["rescan_s"]}
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": out["peak"]}
    line = {"correct": out["failed"] == 0, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        line["breakdown"] = rec["breakdown"]
    line["checks"] = {k: {"value": out["numbers"][k], "limit": v}
                      for k, v in cell["limits"].items()}
    return line
