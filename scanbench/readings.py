"""The readings that each limit of ``limits/<cell>.json`` is set from: the
numbers that decide ``correct``, for the program over many seeds and for
the control, at the cell's own size.

    python3 scanbench/readings.py --workload <name> --seeds <n> [<n> ...]
        --control-seeds <n> [<n> ...]

One process: the cell's set-up and one pass over its pool (the window's
own rescans at the cell's load), then the check's numbers for each seed
(the program's outputs against the float64 reference, as a run with that
seed judges them) and for each control seed (the reference in bfloat16
put in the program's place, which has to come out as not correct). It
also prints every dynamic object's proposals with their score gap and ICP
step, so that a high reading can be traced to its proposal. One JSON line
each, the summary last. The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, ".scanbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from scanbench import harness  # noqa: E402
from scanbench.reference import check  # noqa: E402


def readings(cell: dict, seeds, control_seeds, device, work: str,
             t0: float) -> dict:
    """Per seed, the program's numbers; per control seed, the control's;
    and each proposal's own readings."""
    out = harness.run(cell, seeds[0], 0.0, False, device, work, t0)
    judged, objs = out["judged"], out["objects"]
    sample = cell["traffic"]["proposal_sample"]
    memo: dict = {}
    proposals = []
    for r in judged:
        for i, (poses, _) in sorted(r["proposals"].items()):
            if objs[i]["static"]:
                continue
            for k in range(len(poses)):
                one = dict(r, proposals={i: (r["proposals"][i][0][k:k + 1],
                                             r["proposals"][i][1][k:k + 1])},
                           icp_starts={i: r["icp_starts"][i][k:k + 1]})
                nums = check.judge([one], objs, 0, 0, memo=memo)
                proposals.append({"room": repr(r["room"]), "object": i,
                                  "gt_id": objs[i]["gt_id"], "k": k,
                                  "score": float(r["proposals"][i][1][k]),
                                  "score_gap": nums["score_gap"],
                                  "icp_gap_mm": nums["icp_gap_mm"]})

    def numbers(seed, control):
        per = [check.judge([r], objs, seed, sample, control=control,
                           memo=memo) for r in judged]
        return {k: max(p[k] for p in per) for k in per[0]}

    res = {"setup_s": out["setup_s"], "check_s": out["check_s"],
           "rescans": len(judged),
           "program": {s: numbers(s, False) for s in seeds},
           "control": {s: numbers(s, True) for s in control_seeds}}
    # the control's own readings of each proposal that it judged
    for p in proposals:
        pose = [r for r in judged if repr(r["room"]) == p["room"]][0][
            "proposals"][p["object"]][0][p["k"]]
        at = (p["room"], p["object"], np.asarray(pose, np.float64).tobytes())
        if ("icp_control", *at) in memo:
            p["control_icp_gap_mm"] = check.pose_gap_mm(
                memo[("object", p["object"], check.ICP_LEVEL)]["positions"],
                memo[("icp_control", *at)], memo[("icp", *at)])
            p["control_score_gap"] = abs(memo[("score_control", *at)]
                                         - memo[("score", *at)])
    res["proposals"] = proposals
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scanbench: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device(args.device)
    cell = harness.load_cell(args.workload)
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = tempfile.mkdtemp(prefix="scanbench-", dir=base)
    try:
        t1 = time.perf_counter()
        res = readings(cell, args.seeds, args.control_seeds, dev, work, T0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    limits = cell["limits"]
    for p in res["proposals"]:
        print(json.dumps({"proposal": p}))
    for kind in ("program", "control"):
        for s, nums in res[kind].items():
            print(json.dumps({kind: s, **nums,
                              "over": sorted(k for k in limits
                                             if nums[k] > limits[k])}))
    summary = {"workload": args.workload, "setup_s": res["setup_s"],
               "check_s": res["check_s"],
               "seconds": time.perf_counter() - t1, "limits": limits}
    for kind in ("program", "control"):
        vals = res[kind].values()
        summary[kind] = {k: [min(v[k] for v in vals), max(v[k] for v in vals)]
                         for k in limits}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
