"""Profile one rescan (pose_proposal -> segment_transfer) of the PyTorch
port on the card under torch.profiler: wall seconds per substage, device
busy time, and device time per kernel.

    python tools/profile_torch_port.py [--scene bench|small] [--out DIR]

Needs a CUDA device and raises without one.
The sequence (rescan_tpu_torch.sequences) is written and bootstrapped by
a first driver run, which also builds the kernel; the profiled run then
repeats the rescan from the bootstrap database. Prints one JSON line;
the chrome trace goes to DIR/trace.json when --out is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("bench", "small"), default="bench")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from rescan_tpu_torch import resolve_device, sequences
    from rescan_tpu_torch.ops import gnn, pairsum
    from rescan_tpu_torch.pipeline import (driver, pose_proposal,
                                           segment_transfer)

    dev = resolve_device("cuda")
    write = (sequences.write_bench_sequence if args.scene == "bench"
             else sequences.write_small_sequence)
    with tempfile.TemporaryDirectory() as work:
        class_file = write(work)
        os.chdir(work)
        t0 = time.perf_counter()
        driver.run_sequence(sequences.SEQ_NAME, class_file, device=dev)
        first = time.perf_counter() - t0
        seq = sequences.SEQ_NAME
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        gnn.reset_counts()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            db = pose_proposal.run(os.path.join(seq, "scan_000.rsdb"),
                                   os.path.join(seq, "gt_segmentation",
                                                "scan_001.ply"),
                                   os.path.join(seq, "prof_pp.rsdb"),
                                   device=dev)
            db = segment_transfer.run(os.path.join(seq, "prof_pp.rsdb"),
                                      os.path.join(seq, "prof.rsdb"),
                                      db=db, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    # device-side events only (kernels, copies): a CPU op's own device
    # time repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    print(json.dumps({
        "scene": args.scene, "device": str(dev),
        "card": torch.cuda.get_device_name(0),
        "first_run_s": first, "rescan_wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall,
        "kernel_launches": dict(gnn.LAUNCHES, **pairsum.LAUNCHES),
        "device_time_s_by_op": {e.key: e.self_device_time_total / 1e6
                                for e in events[:12]},
        "device_calls_by_op": {e.key: e.count for e in events[:12]},
        "pose_proposal": db.last_pose_proposal_timings,
        "segment_transfer": db.last_segment_transfer_timings,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
