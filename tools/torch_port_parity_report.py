"""Where the port and the JAX package part ways, measured on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_port_parity_report.py icp [--pair 1]
    JAX_PLATFORMS=cpu python tools/torch_port_parity_report.py small3 [--device cpu]

``icp``: the two-object, 8-pair indexed ICP batch of tests/test_icp.py on
one slab through both packages: per pair, the pose difference and each
side's iteration count; then, for one pair, each intermediate of an ICP
step (JAX's step body re-run under jit on the port's correspondences,
which are bit-identical) at the states of iterations 1 and 2, and the
difference of the 6x6 solves that follow (ROADMAP Queue 3).

``small3``: the port's driver and evaluators over the small 3-scan
sequence on ``--device``, against tests/data/torch_port_small3_ref.npz:
each rescan's largest differences, the tolerance breaches, the metrics;
and what the tolerances in rescan_tpu_torch/sequences.py rest on — the
level-1 sizes of the object models rescan 2 starts from, the level-1
points and class sizes per rescan, and each prediction's overlap with
its GT instance against the nearest AP threshold.
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
    import jax
    import jax.numpy as jnp
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_icp as fx
    from rescan_tpu.ops import icp as jicp
    from rescan_tpu_torch.ops import icp as ticp, search
    from rescan_tpu_torch.ops.reduce import tree_sum

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

    jT = np.asarray(jicp.icp_align_indexed(*jargs)[0])
    tT = port(100)[0].numpy()
    ji = _iterations(lambda k: np.asarray(
        jicp.icp_align_indexed(*jargs, max_iter=k)[2]), len(T0))
    ti = _iterations(lambda k: port(k)[2].numpy(), len(T0))
    print("pair  pose diff   iterations (JAX, port)")
    for p in range(len(T0)):
        print(f"{p:4d}  {np.abs(tT[p] - jT[p]).max():.3g}   {ji[p]}, {ti[p]}")

    obj_pts = targs[0][own]
    obj_nrm = targs[1][own]
    obj_mask = targs[2][own] & targs[4][:, None]
    scene_p, scene_n = search.index_arrays(slab)
    B, N, _ = obj_pts.shape

    @jax.jit
    def jstep(T, idx, d2, dot, dist):
        # icp.py:122-165, the JAX step body up to the normal system
        q = jnp.einsum("bij,bnj->bni", T[:, :3, :3], J(obj_pts.numpy())) \
            + T[:, None, :3, 3]
        ok = (idx >= 0) & J(obj_mask.numpy())
        p2 = J(scene_p.numpy())[jnp.maximum(idx, 0)]
        n2 = J(scene_n.numpy())[jnp.maximum(idx, 0)]
        w = jnp.where(ok, (1.0 - d2 / dist) * dot, 0.0)
        cnt = jnp.maximum(jnp.sum(ok, axis=1), 1)
        mean = jnp.sum(jnp.where(ok, d2, 0.0), axis=1) / cnt
        std = jnp.sqrt(jnp.sum(jnp.where(ok, (d2 - mean[:, None]) ** 2, 0.0),
                               axis=1) / cnt)
        w = jnp.where((std[:, None] <= 1e-6) | (d2 <= 2.5 * std[:, None]),
                      w, 0.0)
        wsum = jnp.sum(w, axis=1)
        wsafe = jnp.maximum(wsum, 1e-30)
        c1 = jnp.einsum("bn,bni->bi", w, q) / wsafe[:, None]
        c2 = jnp.einsum("bn,bni->bi", w, p2) / wsafe[:, None]
        d = (q - c1[:, None, :]) - (p2 - c2[:, None, :])
        ddn = jnp.einsum("bni,bni->bn", d, n2)
        j6 = jnp.concatenate([jnp.cross(q - c1[:, None, :], n2), n2], -1)
        return dict(std=std, wsum=wsum, c1=c1, c2=c2,
                    C=jnp.einsum("bn,bni,bnj->bij", w, j6, j6),
                    b=-jnp.einsum("bn,bni,bn->bi", w, j6, ddn),
                    e2=jnp.einsum("bn,bn->b", w, ddn * ddn))

    def tstep(T, idx, d2, dot, dist):
        # the port's _icp_step, the same quantities
        q = torch.einsum("bij,bnj->bni", T[:, :3, :3], obj_pts) \
            + T[:, None, :3, 3]
        ok = (idx >= 0) & obj_mask
        p2, n2 = scene_p[idx.clamp_min(0)], scene_n[idx.clamp_min(0)]
        w = torch.where(ok, (1.0 - d2 / float(dist)) * dot, 0.0)
        cnt = ok.sum(1).clamp_min(1)
        mean = tree_sum(torch.where(ok, d2, 0.0)) / cnt
        std = torch.sqrt(tree_sum(torch.where(
            ok, (d2 - mean[:, None]) ** 2, 0.0)) / cnt)
        w = torch.where((std[:, None] <= 1e-6) | (d2 <= 2.5 * std[:, None]),
                        w, 0.0)
        s3 = tree_sum(torch.cat([w[..., None], w[..., None] * q,
                                 w[..., None] * p2], -1))
        wsafe = s3[:, 0].clamp_min(1e-30)
        c1, c2 = s3[:, 1:4] / wsafe[:, None], s3[:, 4:7] / wsafe[:, None]
        d = (q - c1[:, None, :]) - (p2 - c2[:, None, :])
        ddn = d[..., 0] * n2[..., 0] + d[..., 1] * n2[..., 1] \
            + d[..., 2] * n2[..., 2]
        j6 = torch.cat([torch.linalg.cross(q - c1[:, None, :], n2), n2], -1)
        wj6 = w[..., None] * j6
        return dict(std=std, wsum=s3[:, 0], c1=c1, c2=c2,
                    C=tree_sum((wj6[..., :, None] * j6[..., None, :])
                               .reshape(B, N, 36)).reshape(B, 6, 6),
                    b=-tree_sum(j6 * (w * ddn)[..., None]),
                    e2=tree_sum(w * (ddn * ddn)))

    def solve(C, b):
        C = torch.as_tensor(np.asarray(C)).double()
        tr = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1)[:, None, None]
        C = C + torch.eye(6, dtype=C.dtype)[None] * (1e-6 * tr / 6.0 + 1e-20)
        x = torch.linalg.solve(C, torch.as_tensor(np.asarray(b)).double()
                               [..., None])[..., 0]
        return x, torch.linalg.cond(C)

    T = T0
    dist = np.float32(0.10)
    for it in (1, 2):
        Tt = torch.from_numpy(np.array(T))
        q = torch.einsum("bij,bnj->bni", Tt[:, :3, :3], obj_pts) \
            + Tt[:, None, :3, 3]
        qn = torch.einsum("bij,bnj->bni", Tt[:, :3, :3], obj_nrm)
        idx, d2, dot = search.nearest_gated(
            slab, q.reshape(B * N, 3), qn.reshape(B * N, 3), dist,
            ticp.cos_gate_of(fx.MAX_ANGLE))
        idx, d2, dot = idx.reshape(B, N).long(), d2.reshape(B, N), \
            dot.reshape(B, N)
        a = jax.device_get(jstep(J(np.array(T)), J(idx.numpy().astype(
            np.int32)), J(d2.numpy()), J(dot.numpy()), dist))
        b = tstep(Tt, idx, d2, dot, dist)
        print(f"pair {pair}, iteration {it} (JAX's state):")
        for k in ("std", "wsum", "c1", "c2", "C", "b", "e2"):
            x, y = np.asarray(a[k])[pair], b[k].numpy()[pair]
            diff = float(np.abs(x - y).max())
            print(f"  {k:4s} max diff {diff:.3g}, relative "
                  f"{diff / max(float(np.abs(x).max()), 1e-30):.3g}")
        xj, cond = solve(a["C"], a["b"])
        xt, _ = solve(b["C"].numpy(), b["b"].numpy())
        print(f"  step x (f64 solves of each side's C, b): max diff "
              f"{float((xj[pair] - xt[pair]).abs().max()):.3g} of "
              f"{float(xj[pair].abs().max()):.3g}, cond(C) "
              f"{float(cond[pair]):.3g}")
        T = np.asarray(jicp.icp_align_indexed(*jargs, max_iter=it)[0])
        dist = np.maximum(np.float32(dist * np.float32(0.95)),
                          np.float32(0.05))
        print(f"  pose diff after iteration {it} (each loop on its own): "
              f"{np.abs(port(it)[0].numpy()[pair] - T[pair]).max():.3g}")


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
    for k, sub in enumerate(sequences.rescans(root)):
        r = sequences.split_outputs(ref, sub)
        g = sequences.split_outputs(got, sub)
        print(f"{sub}: {sequences.output_diffs(r, g)}; breaches "
              f"{sequences.compare_outputs(r, g, augmented=k > 0)}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    a = sub.add_parser("icp")
    a.add_argument("--pair", type=int, default=1)
    b = sub.add_parser("small3")
    b.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    if args.what == "icp":
        icp_report(args.pair)
    else:
        small3_report(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
