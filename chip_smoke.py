"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero before the
result lines:

1. probe   — torch/CUDA versions, nvcc, the card's name and power limit;
             refuses to run without CUDA;
2. build   — the native host library and the CUDA gated-NN kernel, from
             this checkout's sources;
3. kernels — K1 (gated_min) and K2 (nearest_gated) against their plain
             PyTorch versions on the card: random fixtures (both gate
             kinds) and the bench scene's slabs with real scoring and ICP
             queries; bit-identical idx/d2/dot required; both timed;
4. parity  — the port's driver over the small 2-scan sequence, held to
             the JAX package's committed outputs
             (tests/data/torch_port_small_ref.npz);
5. slice   — the port's driver over bench.py's 2-scan scene (seg2rsdb,
             pose_proposal, segment_transfer) on the single device
             [cuda:0], with the kernel launch counts reset just before
             and read just after;
6. mesh    — the same driver on a 4-slot mesh (parallel/mesh.py): four
             slots on cuda:0, or over the visible cards when there are 2
             or more. (a) the small sequence held to the committed JAX
             outputs; (b) the bench sequence held to phase 5's outputs;
             (c) a dp x sp ICP fixture on the bench level-2 slab (2 pairs,
             sp = 2) held to the single-device loop; (d) the torch
             smoothing engine on the bench level-1 graph held to the
             native engine, both timed. K1/K2 launch counts per check;
             plain calls must be 0. A mesh of slots on one card checks
             correctness; it is no scaling figure.

Then one JSON line of per-kernel numbers, the card's nvidia-smi line,
and the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

KERNEL_SOURCE = "rescan_tpu_torch/ops/csrc/gnn.cu"
REPLACES = "rescan_tpu/ops/pallas_nn.py:141"
REF_NPZ = os.path.join(HERE, "tests", "data", "torch_port_small_ref.npz")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs after one
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_probe() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("[probe] FAIL: torch.cuda.is_available() is false")
    from rescan_tpu_torch.ops import gnn
    nvcc = gnn.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    say("probe", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {ver[-1]} | {nvidia_smi_line()} | "
        f"devices {torch.cuda.device_count()}")


def phase_build() -> None:
    from rescan_tpu.core import native
    from rescan_tpu_torch.ops import gnn
    t0 = time.perf_counter()
    native._load()
    t1 = time.perf_counter()
    gnn.load_library()
    t2 = time.perf_counter()
    say("build", f"native host lib {t1 - t0:.2f}s, CUDA gnn kernel "
        f"{t2 - t1:.2f}s")


def _compare(name, kernel_out, plain_out):
    """Mismatch counts and max |kernel - plain| over the finite values."""
    mism, err = [], 0.0
    for k, p in zip(kernel_out, plain_out):
        if k.dtype == torch.float32:
            mism.append(int((k.view(torch.int32) != p.view(torch.int32))
                            .sum()))
            fin = torch.isfinite(k) & torch.isfinite(p)
            if fin.any():
                err = max(err, float((k[fin] - p[fin]).abs().max()))
        else:
            mism.append(int((k != p).sum()))
    if any(mism):
        raise SystemExit(f"[kernels] FAIL {name}: mismatches {mism}")
    return mism, err


def _bench_queries(cuda, root):
    """The bench scene's level-1 and level-2 slabs, a 4M-query scoring
    launch and a 64-pair ICP launch built like the pipeline's."""
    from rescan_tpu.core.pointcloud import PointCloud
    from rescan_tpu.utils import synthetic
    from rescan_tpu_torch.ops import icp, score, search
    from rescan_tpu_torch.pipeline import pose_proposal
    from rescan_tpu_torch.sequences import SEQ_NAME

    gt = os.path.join(root, SEQ_NAME, "gt_segmentation")
    scene = PointCloud.from_ply(os.path.join(gt, "scan_001.ply"))
    base = PointCloud.from_ply(os.path.join(gt, "scan_000.ply"))
    L0 = base.levels[0]
    planar = {synthetic.NYU40_CLASSES.index(c) for c in ("wall", "floor")}
    uid = int(min(L0["instance_ids"][~np.isin(L0["class_ids"],
                                              list(planar))]))
    obj = base.extract_by_ids(0, "instance_ids", [uid], compute_levels=True)
    c = obj.centroid(0).copy()
    c[1] = 0.0
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = -c
    obj.transform(T)

    slab1 = search.build_index(scene.pos(1), normals=scene.nrm(1),
                               device=cuda)
    occ = pose_proposal.SceneOccupancy(scene.pos(1), 0.1,
                                       scene_nrm=scene.nrm(1))
    hyps, _, _ = score.grid_search_hypotheses(scene.bbox[0], scene.bbox[1])
    alive = np.where(occ.score_upper_bound(obj.pos(4), hyps,
                                           obj_nrm=obj.nrm(4)) >= 0.25)[0]
    P, N, _ = score.prep_points(obj.pos(4), obj.nrm(4))
    h = score.MAX_QUERIES_PER_LAUNCH // len(P)
    H = torch.from_numpy(hyps[np.resize(alive, h)]).to(cuda)
    Pt, Nt = torch.from_numpy(P).to(cuda), torch.from_numpy(N).to(cuda)
    sq = (torch.einsum("hij,pj->hpi", H[:, :3, :3], Pt)
          + H[:, None, :3, 3]).reshape(-1, 3).contiguous()
    sqn = torch.einsum("hij,pj->hpi", H[:, :3, :3], Nt).reshape(-1, 3) \
        .contiguous()

    slab2 = search.build_index(scene.pos(2), normals=scene.nrm(2),
                               tile=1024, device=cuda)
    rng = np.random.default_rng(0)
    B = 64
    Ts = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for k in range(B):
        a = rng.uniform(-0.08, 0.08)
        Ts[k, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]]
        Ts[k, :3, 3] = c + rng.uniform(-0.05, 0.05, 3) * [1, 0, 1]
    pb, nb, _ = icp.pad_batch([obj.pos(2)] * B, [obj.nrm(2)] * B)
    Tt = torch.from_numpy(Ts).to(cuda)
    iq = (torch.einsum("bij,bnj->bni", Tt[:, :3, :3],
                       torch.from_numpy(pb).to(cuda))
          + Tt[:, None, :3, 3]).reshape(-1, 3).contiguous()
    iqn = torch.einsum("bij,bnj->bni", Tt[:, :3, :3],
                       torch.from_numpy(nb).to(cuda)).reshape(-1, 3) \
        .contiguous()
    return (slab1, sq, sqn), (slab2, iq, iqn)


def phase_kernels(cuda, bench_root) -> dict:
    from rescan_tpu_torch.ops import gnn, icp, score

    rng = np.random.default_rng(1)
    n, m = 200_000, 1_000_000
    pts = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    pts[n // 2:n // 2 + 5000] = pts[:5000]       # duplicates force ties
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = rng.uniform(0, 4, (m, 3)).astype(np.float32)
    q = q[gnn.morton_order(q)]   # compact query blocks, as callers make
    qn = rng.normal(size=(m, 3)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    qt, qnt = torch.from_numpy(q).to(cuda), torch.from_numpy(qn).to(cuda)
    err = {"gated_min": 0.0, "nearest_gated": 0.0}
    for tile, radius, gate, use_abs in [
            (2048, 0.1, score.SCORE_COS_GATE, False),
            (1024, 0.1, icp.cos_gate_of(np.deg2rad(60.0)), False),
            (2048, 0.075, -1.0, True)]:
        slab = gnn.build_sorted_slab(pts, nrm, tile=tile, device=cuda)
        k2 = gnn.nearest_gated(slab, qt, qnt, radius, gate, use_abs)
        p2 = gnn.nearest_gated_ref(slab, qt, qnt, radius, gate, use_abs)
        k1 = gnn.gated_min(slab, qt, qnt, radius, gate, use_abs)
        _, e2 = _compare("K2 random", k2, p2)
        _, e1 = _compare("K1 random", k1, p2[1:])
        err["nearest_gated"] = max(err["nearest_gated"], e2)
        err["gated_min"] = max(err["gated_min"], e1)
        say("kernels", f"random tile={tile} r={radius} abs={use_abs}: "
            f"{int((p2[0] >= 0).sum())}/{m} found, 0 mismatches")

    (s1, sq, sqn), (s2, iq, iqn) = _bench_queries(cuda, bench_root)
    sr, sg = 0.1, score.SCORE_COS_GATE
    k1 = gnn.gated_min(s1, sq, sqn, sr, sg)
    p1 = gnn.gated_min_ref(s1, sq, sqn, sr, sg)
    _, e1 = _compare("K1 bench scoring", k1, p1)
    ir, ig = 0.1, icp.cos_gate_of(np.deg2rad(60.0))
    k2 = gnn.nearest_gated(s2, iq, iqn, ir, ig)
    p2 = gnn.nearest_gated_ref(s2, iq, iqn, ir, ig)
    _, e2 = _compare("K2 bench ICP", k2, p2)
    err["gated_min"] = max(err["gated_min"], e1)
    err["nearest_gated"] = max(err["nearest_gated"], e2)

    ms = {"gated_min": cuda_ms(lambda: gnn.gated_min(s1, sq, sqn, sr, sg), 5),
          "nearest_gated": cuda_ms(
              lambda: gnn.nearest_gated(s2, iq, iqn, ir, ig), 20)}
    plain_ms = {
        "gated_min": cuda_ms(lambda: gnn.gated_min_ref(s1, sq, sqn, sr, sg),
                             1),
        "nearest_gated": cuda_ms(
            lambda: gnn.nearest_gated_ref(s2, iq, iqn, ir, ig), 3)}
    say("kernels", f"bench K1 scoring launch: {len(sq)} queries on "
        f"{s1.n_valid} level-1 points, {int(torch.isfinite(p1[0]).sum())} "
        f"found, 0 mismatches; kernel {ms['gated_min']:.3f} ms, plain "
        f"{plain_ms['gated_min']:.3f} ms")
    say("kernels", f"bench K2 ICP launch: {len(iq)} queries on "
        f"{s2.n_valid} level-2 points, {int((p2[0] >= 0).sum())} found, "
        f"0 mismatches; kernel {ms['nearest_gated']:.3f} ms, plain "
        f"{plain_ms['nearest_gated']:.3f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def _run_driver(root: str, class_file: str, devices, profiles=None) -> None:
    from rescan_tpu_torch.pipeline import driver
    from rescan_tpu_torch.sequences import SEQ_NAME
    cwd = os.getcwd()
    log = io.StringIO()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(log):
            driver.run_sequence(SEQ_NAME, class_file, profiles=profiles,
                                devices=devices)
    finally:
        os.chdir(cwd)


def _counted(phase: str, what: str, fn):
    """fn() with the kernel launch counts reset just before and read just
    after; fails unless both kernels launched and no plain version ran."""
    from rescan_tpu_torch.ops import gnn
    gnn.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches, plain = dict(gnn.LAUNCHES), dict(gnn.PLAIN_CALLS)
    if min(launches.values()) == 0 or any(plain.values()):
        raise SystemExit(f"[{phase}] FAIL {what}: kernel launches "
                         f"{launches}, plain calls {plain}")
    return out, launches, plain


def _small_parity(phase: str, work: str, devices) -> str:
    """The small sequence through the driver on ``devices``, held to the
    committed JAX outputs; returns a summary."""
    from rescan_tpu_torch import sequences
    root = os.path.join(work, f"small_{len(devices)}")
    class_file = sequences.write_small_sequence(root)
    t0 = time.perf_counter()
    _, launches, plain = _counted(
        phase, "small sequence",
        lambda: _run_driver(root, class_file, devices))
    got = sequences.read_outputs(root)
    ref = dict(np.load(REF_NPZ))
    bad = sequences.compare_outputs(ref, got)
    if bad:
        raise SystemExit(f"[{phase}] FAIL vs "
                         f"{os.path.relpath(REF_NPZ, HERE)}: {bad}")
    starts = np.concatenate([[0], np.cumsum(ref["prop_counts"])[:-1]])
    top = [i for i, n in zip(starts, ref["prop_counts"]) if n]
    return (
        f"small sequence in {time.perf_counter() - t0:.1f}s: "
        f"proposal counts {got['prop_counts'].tolist()} identical; top-1 "
        f"pose max diff "
        f"{np.abs(ref['prop_poses'][top] - got['prop_poses'][top]).max():.3g}"
        f", all scores max diff "
        f"{np.abs(ref['prop_scores'] - got['prop_scores']).max():.3g}, "
        f"arrangement pose max diff "
        f"{np.abs(ref['arr_poses'] - got['arr_poses']).max():.3g}, label "
        f"agreement class "
        f"{(ref['class_ids'] == got['class_ids']).mean():.6f} instance "
        f"{(ref['instance_ids'] == got['instance_ids']).mean():.6f}; "
        f"kernel launches {launches}, plain calls {plain}")


def phase_parity(cuda, work: str) -> None:
    say("parity", _small_parity("parity", work, [cuda]))


def phase_slice(cuda, root: str, class_file: str) -> dict:
    from rescan_tpu_torch import sequences
    profiles = []
    t0 = time.perf_counter()
    _, launches, plain = _counted(
        "slice", "bench sequence",
        lambda: _run_driver(root, class_file, [cuda], profiles=profiles))
    wall = time.perf_counter() - t0
    out = sequences.read_outputs(root)
    counts = out["prop_counts"]
    from rescan_tpu.core import database
    db = database.load_database(
        os.path.join(root, sequences.SEQ_NAME, "scan_000.rsdb"),
        load_pointclouds=False)
    dyn = [i for i in range(len(db.objects)) if not db.is_object_static(i)]
    empty = [i for i in dyn if counts[i] == 0]
    if not dyn or empty:
        raise SystemExit(f"[slice] FAIL: dynamic objects {dyn} without "
                         f"proposals: {empty}")
    for k in ("class_ids", "instance_ids"):
        if not len(out[k]):
            raise SystemExit(f"[slice] FAIL: empty {k}")
    say("slice", f"bench sequence in {wall:.1f}s: kernel launches "
        f"{launches}, plain calls {plain}; proposals per object "
        f"{counts.tolist()}; {len(out['class_ids'])} level-1 points "
        f"labelled")
    p = profiles[0]
    print(json.dumps({"timings": {
        "pose_proposal": {k: round(v, 4) for k, v in
                          p["pose_proposal"].items()},
        "segment_transfer": {k: round(v, 4) for k, v in
                             p["segment_transfer"].items()}}}), flush=True)
    return launches, out


def mesh_slots(n: int = 4) -> list:
    """n shard slots: all on cuda:0 with one card, else round-robin over
    the first n visible cards."""
    count = min(torch.cuda.device_count(), n)
    return [torch.device("cuda", i % count) for i in range(n)]


def _mesh_small(work: str, slots) -> None:
    from rescan_tpu_torch.parallel import mesh as pmesh
    shapes = []
    real = pmesh.icp_refine_indexed_dpsp

    def spy(mesh2d, *a, **k):
        shapes.append(f"dp={mesh2d.dp} x sp={mesh2d.sp}")
        return real(mesh2d, *a, **k)

    pmesh.icp_refine_indexed_dpsp = spy
    try:
        summary = _small_parity("mesh", work, slots)
    finally:
        pmesh.icp_refine_indexed_dpsp = real
    say("mesh", f"(a) {summary}; ICP meshes (pose_proposal, then "
        f"refine-to-scene) {shapes}")


def _mesh_bench(work: str, bench_root: str, class_file: str, slots,
                single: dict) -> None:
    """The bench sequence on the mesh, held to phase 5's outputs."""
    from rescan_tpu_torch import sequences
    root = os.path.join(work, "bench_mesh")
    shutil.copytree(os.path.join(bench_root, sequences.SEQ_NAME, "gt_"
                                 "segmentation"),
                    os.path.join(root, sequences.SEQ_NAME,
                                 "gt_segmentation"))
    profiles = []
    t0 = time.perf_counter()
    _, launches, plain = _counted(
        "mesh", "(b) bench sequence",
        lambda: _run_driver(root, class_file, slots, profiles=profiles))
    wall = time.perf_counter() - t0
    got = sequences.read_outputs(root)
    bad = []
    if not np.array_equal(got["prop_counts"], single["prop_counts"]):
        raise SystemExit(f"[mesh] FAIL (b): proposal counts "
                         f"{got['prop_counts'].tolist()} vs "
                         f"{single['prop_counts'].tolist()}")
    starts = np.concatenate([[0], np.cumsum(single["prop_counts"])[:-1]])
    top = [i for i, n in zip(starts, single["prop_counts"]) if n]
    d_top = float(np.abs(got["prop_poses"][top]
                         - single["prop_poses"][top]).max(initial=0))
    d_all = float(np.abs(got["prop_poses"] - single["prop_poses"])
                  .max(initial=0))
    d_score = float(np.abs(got["prop_scores"] - single["prop_scores"])
                    .max(initial=0))
    if d_top > sequences.TOP1_POSE_TOL:
        bad.append(f"top-1 pose diff {d_top:.3g}")
    for k in ("arr_object_idx", "arr_uidx"):
        if not np.array_equal(got[k], single[k]):
            bad.append(f"arrangement {k} {got[k].tolist()} vs "
                       f"{single[k].tolist()}")
    agree = {k: float((got[k] == single[k]).mean())
             for k in ("class_ids", "instance_ids")
             if len(got[k]) == len(single[k])}
    if len(agree) < 2 or min(agree.values()) < sequences.LABEL_AGREEMENT:
        bad.append(f"label agreement {agree}")
    if bad:
        raise SystemExit(f"[mesh] FAIL (b) vs the single device: {bad}; "
                         f"pose max diff top-1 {d_top:.3g}, all "
                         f"{d_all:.3g}; score max diff {d_score:.3g}")
    p = profiles[0]
    say("mesh", f"(b) bench sequence in {wall:.1f}s: pose_proposal "
        f"{p['pose_proposal']['total']:.4f}s + segment_transfer "
        f"{p['segment_transfer']['total']:.4f}s; proposal counts identical; "
        f"pose max diff top-1 {d_top:.3g}, all {d_all:.3g}; score max diff "
        f"{d_score:.3g}; arrangement identical; label agreement class "
        f"{agree['class_ids']:.6f} instance {agree['instance_ids']:.6f}; "
        f"kernel launches {launches}, plain calls {plain}")


def _mesh_dpsp(bench_root: str, slots) -> None:
    """(c): 2 pairs of a bench object on the bench level-2 slab, pairs over
    dp = 2 and points over sp = 2, against the single-device loop."""
    from rescan_tpu.core.pointcloud import PointCloud
    from rescan_tpu.utils import synthetic
    from rescan_tpu_torch.ops import gnn, icp, search
    from rescan_tpu_torch.parallel import mesh as pmesh
    from rescan_tpu_torch.sequences import SEQ_NAME

    gt = os.path.join(bench_root, SEQ_NAME, "gt_segmentation")
    scene = PointCloud.from_ply(os.path.join(gt, "scan_001.ply"))
    base = PointCloud.from_ply(os.path.join(gt, "scan_000.ply"))
    lead = slots[0]
    slab = search.build_index(scene.pos(2), normals=scene.nrm(2), tile=1024,
                              device=lead)
    L0 = base.levels[0]
    planar = {synthetic.NYU40_CLASSES.index(c) for c in ("wall", "floor")}
    # the bench's second and third objects (a chair and the table), which
    # stay in place in the rescan
    uids = np.unique(L0["instance_ids"][~np.isin(L0["class_ids"],
                                                 list(planar))])
    uids = uids[1:3] if len(uids) >= 3 else uids[:2]
    objs = [base.extract_by_ids(0, "instance_ids", [int(u)],
                                compute_levels=True) for u in uids]
    upts, unrm, umask = icp.prep_unique_batch([o.pos(2) for o in objs],
                                              [o.nrm(2) for o in objs])
    rng = np.random.default_rng(5)
    T0 = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    for k in range(2):
        a = rng.uniform(-0.05, 0.05)
        T0[k, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]]
        T0[k, :3, 3] = rng.uniform(-0.03, 0.03, 3) * [1, 0, 1]
    own, val = np.arange(2), np.ones(2, bool)
    m = pmesh.make_mesh(4, sp=2, devices=slots)
    args = (0.075, np.deg2rad(50.0))
    gnn.reset_counts()
    t0 = time.perf_counter()
    T_sh, _ = pmesh.icp_refine_indexed_dpsp(m, slab, upts, unrm, umask, own,
                                            val, T0, *args)
    t_sh = time.perf_counter() - t0
    launches, plain = dict(gnn.LAUNCHES), dict(gnn.PLAIN_CALLS)
    if launches["nearest_gated"] == 0 or any(plain.values()):
        raise SystemExit(f"[mesh] FAIL (c): kernel launches {launches}, "
                         f"plain calls {plain}")
    t0 = time.perf_counter()
    T1, _, _, n_iter = icp.icp_align_indexed(
        *(torch.from_numpy(a).to(lead) for a in (upts, unrm, umask, own,
                                                 val)),
        slab, torch.from_numpy(T0).to(lead), *args)
    T1 = T1.cpu().numpy()
    t_1 = time.perf_counter() - t0
    res = []
    for k, o in enumerate(objs):
        p = o.pos(2)
        a = p @ T1[k, :3, :3].T + T1[k, :3, 3]
        b = p @ T_sh[k, :3, :3].T + T_sh[k, :3, 3]
        res.append(float(np.abs(a - b).mean()))
    moved = [float(np.abs(T1[k] - T0[k]).max()) for k in range(2)]
    if max(res) >= 1e-3 or not max(moved) > 0:
        raise SystemExit(f"[mesh] FAIL (c): residuals {res}, moved {moved}")
    say("mesh", f"(c) dp x sp ICP, 2 pairs ({upts.shape[1]} points each) "
        f"on the {slab.n_valid}-point level-2 slab, {m.shape}: mean "
        f"residual vs single {max(res):.3g} (limit 1e-3), pose max diff "
        f"{np.abs(T_sh - T1).max():.3g}, {n_iter} iterations; "
        f"{t_sh:.3f}s vs single {t_1:.3f}s (host clock); kernel launches "
        f"{launches}, plain calls {plain}")


def _mesh_smoothing(bench_root: str, lead) -> None:
    """(d): the torch engine against the native one on the rescan's
    level-1 graph, from its predicted labels with 10 % of them set to a
    random other label (seeded), both timed."""
    from rescan_tpu.core import database
    from rescan_tpu.core.pointcloud import PointCloud
    from rescan_tpu_torch.ops import labels
    from rescan_tpu_torch.sequences import RESCAN, SEQ_NAME

    seq = os.path.join(bench_root, SEQ_NAME)
    db = database.load_database(os.path.join(seq, f"{RESCAN}.rsdb"),
                                load_pointclouds=False)
    cloud = PointCloud.from_ply(os.path.join(seq, "predictions",
                                             f"{RESCAN}.ply"))
    L = cloud.levels[0]
    rng = np.random.default_rng(11)
    flip = rng.random(len(L["instance_ids"])) < 0.1
    donors = rng.integers(0, len(L["instance_ids"]), int(flip.sum()))
    for k in ("class_ids", "instance_ids"):
        L[k] = L[k].copy()
        L[k][flip] = L[k][donors]
    cloud.levels[1] = {k: v.copy() for k, v in L.items()}
    t0 = time.perf_counter()
    labels.build_smoothing_graph(cloud)
    t_graph = time.perf_counter() - t0
    out, secs = {}, {}
    for engine, dev in (("native", None), ("torch", lead), ("torch", lead)):
        c = copy.deepcopy(cloud)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels.smooth_labels(db, c, engine=engine, device=dev)
        torch.cuda.synchronize()
        secs[engine] = time.perf_counter() - t0
        out[engine] = c.levels[1]
    agree = {k: float((out["torch"][k] == out["native"][k]).mean())
             for k in ("class_ids", "instance_ids")}
    changed = float((out["torch"]["instance_ids"]
                     != cloud.levels[1]["instance_ids"]).mean())
    if min(agree.values()) < 0.995 or changed == 0:
        raise SystemExit(f"[mesh] FAIL (d): agreement {agree}, changed "
                         f"{changed}")
    say("mesh", f"(d) smoothing of {len(L['instance_ids'])} level-1 points "
        f"({flip.mean():.3f} relabelled at random): torch engine on {lead} "
        f"{secs['torch']:.3f}s (second call) vs native {secs['native']:.3f}s "
        f"(host), each including the {t_graph:.3f}s host graph build; "
        f"agreement class {agree['class_ids']:.6f} instance "
        f"{agree['instance_ids']:.6f}; {changed:.4f} of labels changed")


def phase_mesh(work: str, bench_root: str, bench_class: str,
               single: dict) -> None:
    slots = mesh_slots()
    where = ("4 slots on cuda:0" if len(set(slots)) == 1 else
             f"4 slots over cards {sorted({d.index for d in slots})}")
    say("mesh", f"{where}: {[str(d) for d in slots]}")
    _mesh_small(work, slots)
    _mesh_bench(work, bench_root, bench_class, slots, single)
    _mesh_dpsp(bench_root, slots)
    _mesh_smoothing(bench_root, slots[0])


def main() -> int:
    phase_probe()
    cuda = torch.device("cuda", 0)
    phase_build()
    from rescan_tpu_torch import sequences
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        bench_root = os.path.join(work, "bench")
        t0 = time.perf_counter()
        bench_class = sequences.write_bench_sequence(bench_root)
        say("kernels", f"bench scans written in "
            f"{time.perf_counter() - t0:.1f}s")
        kern = phase_kernels(cuda, bench_root)
        phase_parity(cuda, work)
        launches, single = phase_slice(cuda, bench_root, bench_class)
        phase_mesh(work, bench_root, bench_class, single)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = [{"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES, "launches": launches[name],
                "max_abs_err": kern["err"][name], "ms": kern["ms"][name],
                "plain_ms": kern["plain_ms"][name]}
               for name in ("gated_min", "nearest_gated")]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
