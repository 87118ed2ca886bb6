"""Where the port and the JAX package part ways, measured on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_port_parity_report.py icp [--pair 1]
    JAX_PLATFORMS=cpu python tools/torch_port_parity_report.py small3 [--device cpu]
    python tools/torch_port_parity_report.py engines

``icp``: the two-object, 8-pair indexed ICP batch of tests/test_icp.py on
one slab through both packages: per pair, the pose and error differences
and each side's iteration count; then one port step from each of JAX's
first states (the correspondences are bit-identical) and how far it lands
from JAX's next state, for every pair and for ``--pair`` (ROADMAP
Queue 3).

``small3``: the port's driver and evaluators over the small 3-scan
sequence on ``--device``, against the JAX package's runs on the sorted
slab and on the CPU's HashGrid (tests/data/torch_port_small3{_slab,}_ref
.npz): each rescan's largest differences, the tolerance breaches, the
metrics;
and what the tolerances in rescan_tpu_torch/sequences.py rest on — the
level-1 sizes of the object models rescan 2 starts from, the level-1
points and class sizes per rescan, and each prediction's overlap with
its GT instance against the nearest AP threshold.

``engines``: the JAX package's own two runs of each committed sequence,
on the sorted slab and on the CPU's HashGrid, against each other (the
small 3-scan sequence's rescans, and the bench rescan): how far its two
search engines part, which rescan_tpu_torch/sequences.py's OTHER_ENGINE
limits rest on. Reads the committed files only.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF3 = os.path.join(ROOT, "tests", "data", "torch_port_small3_ref.npz")
REF3_SLAB = os.path.join(ROOT, "tests", "data",
                         "torch_port_small3_slab_ref.npz")
BENCH = os.path.join(ROOT, "tests", "data", "torch_port_bench_ref.npz")
BENCH_SLAB = os.path.join(ROOT, "tests", "data",
                          "torch_port_bench_slab_ref.npz")


def _iterations(run, n_pairs: int) -> np.ndarray:
    """Each pair's iteration count: the first max_iter after which it is
    no longer active."""
    stop = np.full(n_pairs, -1)
    for k in range(1, 60):
        act = run(k)
        stop[(stop < 0) & ~act] = k
        if not act.any():
            break
    return stop


def icp_report(pair: int) -> None:
    import jax.numpy as jnp
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_icp as fx
    from rescan_tpu.ops import icp as jicp
    from rescan_tpu_torch.ops import icp as ticp, search

    scene_pts, scene_nrm, (upts, unrm, umask, own, val, T0) = \
        fx._indexed_case(12345)
    js, slab = fx._slab_pair(scene_pts, scene_nrm)
    J = jnp.asarray
    jargs = (J(upts), J(unrm), J(umask), J(own), J(val), js, J(T0), 0.10,
             fx.MAX_ANGLE)
    targs = [torch.from_numpy(a) for a in (upts, unrm, umask, own, val)]

    def port(k):
        return ticp.icp_align_indexed(*targs, slab, torch.from_numpy(T0),
                                      0.10, fx.MAX_ANGLE, max_iter=k)

    jT, jerr, _ = (np.asarray(x) for x in jicp.icp_align_indexed(*jargs))
    tT, terr = (x.numpy() for x in port(100)[:2])
    ji = _iterations(lambda k: np.asarray(
        jicp.icp_align_indexed(*jargs, max_iter=k)[2]), len(T0))
    ti = _iterations(lambda k: port(k)[2].numpy(), len(T0))
    print("pair  pose diff   err diff   iterations (JAX, port)")
    for p in range(len(T0)):
        print(f"{p:4d}  {np.abs(tT[p] - jT[p]).max():.3g}   "
              f"{abs(float(terr[p] - jerr[p])):.3g}   {ji[p]}, {ti[p]}")

    obj_pts = targs[0][own]
    obj_nrm = targs[1][own]
    obj_mask = targs[2][own] & targs[4][:, None]
    scene_p, scene_n = search.index_arrays(slab)
    T, err = J(T0), J(np.full(len(T0), 1e6, np.float32))
    # a JAX loop resumed at a state restarts every valid pair as active
    active = torch.from_numpy(umask[own].any(1) & val)
    dist = np.float32(0.10)
    print(f"one port step from JAX's state (pair {pair}; all pairs):")
    for k in range(int(ji.max())):
        nT, nerr, _ = (np.asarray(x) for x in jicp.icp_align_indexed(
            *jargs[:6], T, dist, fx.MAX_ANGLE, max_iter=k + 1,
            err_init=err, it_init=k))
        sT, serr, _ = ticp._icp_step(
            obj_pts, obj_nrm, obj_mask, slab, scene_p, scene_n,
            torch.from_numpy(np.array(T)), torch.from_numpy(np.array(err)),
            dist, active, k, ticp.cos_gate_of(fx.MAX_ANGLE))
        d = np.abs(sT.numpy() - nT).max(axis=(1, 2))
        print(f"  iteration {k + 1}: pose diff {d[pair]:.3g}, err diff "
              f"{abs(float(serr[pair] - nerr[pair])):.3g}; bit-identical "
              f"pairs {int((d == 0).sum())} of {len(d)}")
        T, err = J(nT), J(nerr)
        dist = np.maximum(np.float32(dist * np.float32(0.95)),
                          np.float32(0.05))


def small3_report(device: str) -> None:
    import contextlib
    import io
    from rescan_tpu_torch import sequences
    from rescan_tpu_torch.core import database
    from rescan_tpu_torch.eval import semantic_instance
    from rescan_tpu_torch.pipeline import driver

    root = tempfile.mkdtemp(prefix="small3_")
    class_file = sequences.write_eval_sequence(root, small=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            driver.run_sequence(sequences.SEQ_NAME, class_file, device=device,
                                eval_folder=os.path.join(root, "eval"))
            db = database.load_database(
                os.path.join(sequences.SEQ_NAME, "scan_001.rsdb"))
    finally:
        os.chdir(cwd)
    ref = dict(np.load(REF3))
    got = sequences.sequence_outputs(root)
    for name, path in (("slab", REF3_SLAB), ("HashGrid", REF3)):
        src = dict(np.load(path))
        for sub in sequences.rescans(root):
            r = sequences.split_outputs(src, sub)
            g = sequences.split_outputs(got, sub)
            print(f"{sub} vs the JAX package's {name} run: "
                  f"{sequences.output_diffs(r, g)}; breaches "
                  f"{sequences.compare_outputs(r, g)}")
    metrics = sequences.evaluate_sequence(root, device=device)
    for k in sequences.METRICS:
        print(f"{k}: port {metrics[k]!r}, JAX {float(ref['metric/' + k])!r}")
    print("object models rescan 2 starts from (uidx, class, level-1 points):",
          [(o.uidx, o.class_idx, len(o.cloud.levels[1]["positions"]))
           for o in db.objects])
    ev = os.path.join(root, "eval")
    for sub in sequences.rescans(root):
        gl = np.loadtxt(os.path.join(ev, "semantic_label", "gt_segmentation",
                                     sub + ".txt"), dtype=np.int64)
        print(f"{sub}: {len(gl)} level-1 points; GT points per class",
              {int(c): int((gl == c).sum()) for c in np.unique(gl)})
        p = os.path.join(ev, "semantic_instance", "predictions", sub + ".txt")
        _, preds = semantic_instance.assign_instances_for_scan(
            p, p.replace("predictions", "gt_segmentation"), device)
        for name, lst in preds.items():
            for pr in lst:
                for m in pr["matched_gt"]:
                    union = m["vert_count"] + pr["vert_count"] \
                        - m["intersection"]
                    ov = m["intersection"] / union
                    gap = min(abs(ov - t) for t in semantic_instance.OVERLAPS)
                    print(f"  {name}: overlap {ov:.5f} with GT "
                          f"{m['instance_id']}, union {union}; nearest AP "
                          f"threshold {gap:.5f} away (~{gap * union:.0f} "
                          f"points)")


def engines_report() -> None:
    from rescan_tpu_torch import sequences
    slab, grid = dict(np.load(REF3_SLAB)), dict(np.load(REF3))
    pairs = [(f"small 3-scan {sub}", sequences.split_outputs(slab, sub),
              sequences.split_outputs(grid, sub))
             for sub in ("scan_001", "scan_002")]
    if os.path.exists(BENCH_SLAB):
        pairs.append(("bench", dict(np.load(BENCH_SLAB)),
                      dict(np.load(BENCH))))
    else:
        print(f"no {os.path.relpath(BENCH_SLAB, ROOT)}")
    for name, s, g in pairs:
        print(f"{name}, slab run vs HashGrid run: "
              f"{sequences.output_diffs(s, g)}; breaches at the "
              f"other-engine limits {sequences.compare_outputs(s, g, True)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    a = sub.add_parser("icp")
    a.add_argument("--pair", type=int, default=1)
    b = sub.add_parser("small3")
    b.add_argument("--device", default="cpu")
    sub.add_parser("engines")
    args = ap.parse_args(argv)
    if args.what == "icp":
        icp_report(args.pair)
    elif args.what == "small3":
        small3_report(args.device)
    else:
        engines_report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
