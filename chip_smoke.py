"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero before the
result lines:

1. probe   — torch/CUDA versions, nvcc, the card's name and power limit;
             refuses to run without CUDA;
2. build   — the native host library and the four CUDA libraries (gated
             NN; per-pair sums, fma chains, the 6x6 solve, XLA's f32 math,
             scoring's per-point terms and the ICP step's head and tail;
             the grid and dense search engines; the LoD levels' pass),
             from this checkout's sources, the five compilers started
             together; ptxas's report
             and, per gated-NN instantiation and ICP head form, its
             residency (CTAs per SM by the occupancy calculator,
             registers, shared and local bytes); fails unless ptxas gives
             every instantiation of icp_head_kernel, icp_tail_kernel,
             lu6_kernel, grid_radius_knn_kernel,
             grid_nearest_gated_kernel and dense_nearest_kernel a 0-byte
             stack frame and no spills (every value in registers);
3. kernels — K1 (gated_min) and K2 (nearest_gated) against their plain
             PyTorch versions on the card: random fixtures (duplicated
             points, both tile sizes, both gate kinds, a query count that
             is no multiple of the 128-query block, a block of real and
             far queries) and two bench launches built as the pipeline
             builds them (the K1 scoring launch, the K2 ICP launch);
             bit-identical idx/d2/dot required. The studio cell's scan
             (scanbench's studio-6x6-10obj), whose level-1 index is split
             into a SlabSet: K1 over the set on its largest scoring launch
             bit for bit against the plain version over the same parts,
             timed beside one slab of the same points, with both pair
             counts, then a launch of each other class of the studio's
             objects timed alike. For each bench launch:
             kernel and plain times, the pairs the kernel evaluates (the
             host count of its run pruning) and the pairs within r, and
             the bound. The grid kernels (radius_knn at K 8 and 16,
             nearest_gated) and the dense kernel against their plain
             versions, bit for bit, on the same random fixture, and the
             grid and dense nearest_gated on the queries of both bench
             launches (each engine built on the launch's scene points, the
             grid with the JAX package's cell), with kernel and plain
             times, pairs evaluated and within r, the bound and K1/K2's
             time on the same queries. Then K1's time on the scoring
             launch at several shared-memory carveouts, i.e. at fewer
             CTAs per SM. Then
             pairsum (the ICP's and scoring's per-pair sums in the JAX
             package's order) against its plain version, bit for bit: random
             rows of every kind up to 32768 points, whole and chained over
             runs of points, the one-pair FOLDED kinds at 128 and 256,
             and the ICP step's two heavy rounds at the bench ICP launch's
             shape (64 pairs), with kernel, plain and torch.bmm times, the
             byte bound and the CHAIN sums' latency floor; the fma chains
             (scoring's two transforms at 4,194,304 points) and the score
             terms (at the bench K1 scoring launch) against their plain
             versions and torch.addcmul; the XLA-math kernel's operations
             on 1,048,576 arguments against their plain versions; the LoD
             levels' card pass on the bench scan at the four voxels,
             index for index against the native pass, both timed, with
             its rounds and byte bound;
4. parity  — the port's driver over the small 2-scan sequence, held to
             the JAX package's committed outputs
             (tests/data/torch_port_small_ref.npz, its run on the CPU's
             HashGrid); then again with every index a HashGrid
             (search.build_index with prefer_dense=False): no slab kernel
             launched, every grid kernel did, held at the same limits,
             the output differences printed;
5. slice   — the port's driver over bench.py's 2-scan scene (seg2rsdb,
             pose_proposal, segment_transfer) on the single device
             [cuda:0], with the kernel launch counts reset just before
             and read just after (every level of the rescans built on the
             card: the native pass may run only in seg2rsdb's bootstrap,
             which takes no device), held to the JAX package's outputs on
             the same sequence (tests/data/torch_port_bench_slab_ref.npz,
             its run on the sorted slab, at sequences.compare_outputs's
             limits; tests/data/torch_port_bench_ref.npz, its run on the
             CPU's HashGrid, the lower-ranked proposals at the
             other-engine limits); the
             ICP substages' seconds beside those of the tree-ordered
             sums this step had before; the label transfer's
             K2 launches of that run are recorded and then held to the
             plain version and measured as the bench launches of phase 3
             are, and so is the first launch of every shape of that run
             of pairsum, the fma chains, the score terms, the ICP head
             (of every form) and the ICP tail (the tail: of every pair
             count, before and after the convergence test starts), each
             measured at its largest (beside torch.addcmul, a byte-rate
             yardstick; the head and the tail beside the launch floor, an
             empty kernel; the tail beside torch.linalg.solve_ex of its
             systems; the head's plain version on CPU copies of its
             operands, each form beside its byte bound, its shared memory
             and its residency); the standalone lu6 and XLA-math kernels,
             whose device functions the tail runs, on the tail launches'
             systems and angles, held and measured alike; the rescan's
             distance from the slab run, the fma-family launches, and the
             augmentation ICP's placements of 256 points or fewer;
             label_smooth split into the smoothing graph's radius search
             (grid build, grid_radius_knn), native smooth_graph and the
             alpha-beta swap; that search's launch held to its plain
             version bit for bit and timed beside the native HostGrid's
             host search of the same points, whose graph must have the
             same edges and weights within rtol 1e-6; the grid and dense
             engines on the largest label-transfer launch's queries, as
             in phase 3;
6. mesh    — the same driver on a 4-slot mesh (parallel/mesh.py): four
             slots on cuda:0, or over the visible cards when there are 2
             or more. (a) the small sequence held to the committed JAX
             outputs; (b) the bench sequence held to phase 5's outputs;
             (c) a dp x sp ICP fixture on the bench level-2 slab (2 pairs,
             sp = 2) held to the single-device loop; (d) the torch
             smoothing engine on the bench level-1 graph held to the
             native engine, both timed. K1/K2 launch counts per check;
             plain calls must be 0. A mesh of slots on one card checks
             correctness; it is no scaling figure;
7. eval    — the evaluation and viewing path on [cuda:0]. (a) the small
             3-scan sequence through the driver with eval files, both
             rescans held bit for bit to the JAX package's
             committed run on the sorted slab
             (tests/data/torch_port_small3_slab_ref.npz), both also to its
             run on the CPU's HashGrid (rescan 2's lower-ranked proposals
             at the other-engine limits), and the five metrics to the
             committed metrics (tests/data/torch_port_small3_ref.npz);
             (b) the bench room
             as a 3-scan sequence (chair 0 moved, then the sofa): seconds
             per rescan with substage timings, the three evaluators on
             the card, equal to the same evaluators on the CPU, beside
             RESULTS_r02.json's TPU numbers (context, not a gate); (c) the
             viewer on (b)'s last database at 1024x768 in four
             configurations, each card image held to the CPU render
             (byte for byte without EDL and colour maps, else at most
             0.1 % of pixels off by one level), ms per render, and the
             CLI's PNG written and read back. Calls of the eval, viewer and
             distance-field device work on CPU tensors during the card's
             runs of (b) and (c) must be 0.

Then one JSON line of per-kernel numbers, the card's nvidia-smi line,
and the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

KERNEL_SOURCE = "rescan_tpu_torch/ops/csrc/gnn.cu"
REPLACES = "rescan_tpu/ops/pallas_nn.py:141"
PAIRSUM_SOURCE = "rescan_tpu_torch/ops/csrc/pairsum.cu"
PORT_KERNELS = ("pairsum", "fma", "lu6", "xla_math", "score_terms",
                "icp_head", "icp_tail")
# the standalone 6x6 solve and XLA-math kernels: the main path runs their
# device functions inside icp_tail_kernel, and launches them on their own
# nowhere
INSIDE_TAIL = ("lu6", "xla_math")
SOURCES = dict.fromkeys(PORT_KERNELS, PAIRSUM_SOURCE)
# no Pallas kernel: XLA's compiled arithmetic of the ICP step and of
# scoring: the step's sums (from the first), its fused products (from the
# first), its 6x6 solve, the rotation's cos and sin (XLA's f32 functions),
# scoring's per-point terms, the step's per-point work between its sums
# (from the gathers), the step's tail after its sums (from the trace)
REPLACES_OF = {"pairsum": "rescan_tpu/ops/icp.py:132",
               "fma": "rescan_tpu/ops/icp.py:101",
               "lu6": "rescan_tpu/ops/icp.py:162",
               "xla_math": "rescan_tpu/ops/icp.py:43",
               "score_terms": "rescan_tpu/ops/score.py:160",
               "icp_head": "rescan_tpu/ops/icp.py:125",
               "icp_tail": "rescan_tpu/ops/icp.py:160"}
# the JAX package's two other search engines (no Pallas kernel either:
# what XLA compiled for hashgrid.radius_knn, hashgrid.nearest_gated and
# dense_nn._nearest_chunk); the main path runs the first, in the smoothing
# graph's search
GRID_SOURCE = "rescan_tpu_torch/ops/csrc/hashgrid.cu"
ENGINE_KERNELS = ("grid_radius_knn", "grid_nearest_gated", "dense_nearest")
SOURCES.update(dict.fromkeys(ENGINE_KERNELS, GRID_SOURCE))
REPLACES_OF.update({"grid_radius_knn": "rescan_tpu/ops/hashgrid.py:198",
                    "grid_nearest_gated": "rescan_tpu/ops/hashgrid.py:164",
                    "dense_nearest": "rescan_tpu/ops/dense_nn.py:71"})
# the LoD levels' greedy Poisson-disk pass (no Pallas kernel: the JAX
# package builds every level on the host with the native pass)
SOURCES["poisson_levels"] = "rescan_tpu_torch/ops/csrc/levels.cu"
REPLACES_OF["poisson_levels"] = "rescan_tpu/core/pointcloud.py:183"
# the kernels every rescan on the main path launches
PATH_KERNELS = (("gated_min", "nearest_gated")
                + tuple(k for k in PORT_KERNELS if k not in INSIDE_TAIL)
                + ("grid_radius_knn", "poisson_levels"))
# the kernels whose ptxas report must show no stack frame and no spills
# (every instantiation): every value in registers; per library
REGISTER_RESIDENT = ("icp_head_kernel", "icp_tail_kernel", "lu6_kernel")
GRID_RESIDENT = ("grid_radius_knn_kernel", "grid_nearest_gated_kernel",
                 "dense_nearest_kernel")
REF_NPZ = os.path.join(HERE, "tests", "data", "torch_port_small_ref.npz")
REF3_NPZ = os.path.join(HERE, "tests", "data", "torch_port_small3_ref.npz")
REF3_SLAB_NPZ = os.path.join(HERE, "tests", "data",
                             "torch_port_small3_slab_ref.npz")
BENCH_NPZ = os.path.join(HERE, "tests", "data", "torch_port_bench_ref.npz")
BENCH_SLAB_NPZ = os.path.join(HERE, "tests", "data",
                              "torch_port_bench_slab_ref.npz")
# the ICP substages of phase 5's rescan while the step's per-pair sums were
# a fixed tree (the parent commit's chip_smoke.py phase 5, run in one chip
# call with this one's on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md).
# Context, not a gate: host clocks move between calls
TREE_SUM_ICP_SECONDS = {"icp_refine": 0.2122, "refine_to_scene": 0.157,
                        "aug_icp": 0.5066}
# The bound's rates: NVIDIA's H100 SXM data sheet (HBM3, and FP32 outside
# the tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
# FP32 work of one pair within r: d2 (3 subtractions, a multiply, two
# FMAs = 8 flops) and the normal dot (a multiply, two FMAs = 5 flops);
# radius_knn's needs d2 alone
FLOP_PER_PAIR = 13
FLOP_PER_KNN_PAIR = 8
# a dependent FP32 FMA's latency on Hopper, in cycles: the floor of a
# chain of n of them is n * 4 cycles at the SM clock
FMA_LATENCY_CYCLES = 4


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True)
    return float(r.stdout.strip().splitlines()[0])


# the spin kernel that a timed run of calls is queued behind, in seconds at
# the highest SM clock: longer than the host takes to queue the calls
SPIN_SECONDS = 0.02
# how every kernel's and library call's ms is measured (queued_ms)
TIMING = ("CUDA events around back-to-back calls queued behind a spin "
          "kernel")


def queued_ms(fn, reps: int = 20) -> tuple:
    """(mean device milliseconds of one call of ``fn``, calls made): CUDA
    events around ``reps`` back-to-back calls after one warm-up, queued
    behind a spin kernel (torch.cuda._sleep) so that the card runs them
    one after another with none of the host's work between them. Kernel
    wrappers and library calls are timed alike. Where the spin ended
    before the last call was queued (a call that waited on the card, or a
    host slower than the spin), the run is made again behind a spin four
    times longer; after three runs this fails: no other measure takes its
    place."""
    fn()
    torch.cuda.synchronize()
    calls = 1
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    cycles = int(SPIN_SECONDS * sm_clock_mhz() * 1e6)
    for _ in range(3):
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        hidden = not a.query()
        calls += reps
        torch.cuda.synchronize()
        if hidden:
            return a.elapsed_time(b) / reps, calls
        cycles *= 4
    raise SystemExit(f"[timing] FAIL: {reps} calls were not queued within "
                     f"a spin of {cycles // 4} cycles")


def _launched(counter: str) -> int:
    return _counts()[0][counter]


def kernel_ms(kern, counter: str, reps: int = 20) -> float:
    """queued_ms of a kernel wrapper that launches the kernel counted as
    ``counter`` once a call; fails where the count moved otherwise."""
    n0 = _launched(counter)
    ms, calls = queued_ms(kern, reps)
    if _launched(counter) - n0 != calls:
        raise SystemExit(f"[timing] FAIL: {calls} calls launched "
                         f"{_launched(counter) - n0} {counter} kernels")
    return ms


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up, by
    CUDA events around the calls: the host's work between launches and
    any wait on the card included (plain versions)."""
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


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from rescan_tpu_torch.core import native
    from rescan_tpu_torch.ops import gnn, hashgrid, levels, pairsum
    # one compiler per source, all started together
    with ThreadPoolExecutor(5) as ex:
        jobs = [ex.submit(_timed, f) for f in (
            native._load, gnn.load_library, pairsum.load_library,
            hashgrid.load_library, levels.load_library)]
        (lib, t_native), (_, t_gnn), (_, t_sum), (_, t_grid), \
            (_, t_levels) = (j.result() for j in jobs)
    say("build", f"native host lib {os.path.relpath(lib._name, HERE)} "
        f"{t_native:.2f}s, CUDA gnn kernel {t_gnn:.2f}s, CUDA pairsum "
        f"kernel {t_sum:.2f}s, CUDA grid and dense kernels {t_grid:.2f}s, "
        f"CUDA LoD level kernels {t_levels:.2f}s (built side by side)")
    for line in (gnn.BUILD_LOG + pairsum.BUILD_LOG + hashgrid.BUILD_LOG
                 + levels.BUILD_LOG).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", "ptxas " + line.strip())
    for log, kernel in ([(pairsum.BUILD_LOG, k) for k in REGISTER_RESIDENT]
                        + [(hashgrid.BUILD_LOG, k) for k in GRID_RESIDENT]):
        for name, use in ptxas_usage(log, kernel).items():
            say("build", f"ptxas {name}: {use['registers']} registers, "
                f"{use['stack']} bytes stack frame, {use['spill_stores']} "
                f"bytes spill stores, {use['spill_loads']} bytes spill loads")
            if use["stack"] or use["spill_stores"] or use["spill_loads"]:
                raise SystemExit(f"[build] FAIL {name}: not "
                                 f"register-resident ({use})")
    from rescan_tpu_torch.ops import icp
    for form in icp.HEAD_FORMS:
        i = icp.head_info(form, torch.device("cuda", 0))
        say("build", f"icp_head_kernel form {'ABCD'[form]}: "
            f"{i['ctas_per_sm']} CTAs per SM (occupancy calculator); "
            f"{i['registers']} registers, {i['shared_bytes']} B shared a "
            f"CTA, {i['local_bytes']} B local")
    # what would cap the CTAs per SM, each alone, on an H100: 65,536
    # registers (allocated per warp in units of 256), 228 KiB of shared
    # memory (1 KiB of it reserved per CTA), 32 CTA slots
    for want_idx in (False, True):
        for use_abs in (False, True):
            i = gnn.kernel_info(want_idx, use_abs, torch.device("cuda", 0))
            by_regs = 65536 // (-(-i["registers"] * 32 // 256) * 256)
            by_smem = 228 * 1024 // (i["shared_bytes"] + 1024)
            say("build", f"gnn_kernel<{str(want_idx).lower()}, "
                f"{str(use_abs).lower()}>: {i['ctas_per_sm']} CTAs per SM "
                f"(occupancy calculator, default carveout); "
                f"{i['registers']} registers, {i['shared_bytes']} B shared, "
                f"{i['local_bytes']} B local; alone, registers would allow "
                f"{by_regs}, shared memory {by_smem}, CTA slots 32")


def ptxas_usage(log: str, kernel: str) -> dict:
    """Each instantiation of a kernel (by its mangled name) with its
    registers, stack frame and spills (bytes) from ptxas's -v report;
    fails where the report does not give them all."""
    lines = log.splitlines()
    uses = {}
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S+)", line)
        if m and kernel in m.group(1):
            st = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", lines[i + 1])
            if st:
                uses.setdefault(m.group(1), {}).update(zip(
                    ("stack", "spill_stores", "spill_loads"),
                    map(int, st.groups())))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and kernel in m.group(1):
            for nxt in lines[i + 1:]:
                r = re.search(r"Used (\d+) registers", nxt)
                if r:
                    uses.setdefault(m.group(1), {})["registers"] = int(
                        r.group(1))
                    break
    if not uses or any(len(u) != 4 for u in uses.values()):
        raise SystemExit(f"[build] FAIL: ptxas's report does not give "
                         f"{kernel}'s registers, stack and spills")
    return uses


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
    """The bench scene's K1 and K2 launches, built as the pipeline builds
    them: (slab, queries, normals, radius, cos_gate, use_abs) of the K1
    4M-query scoring launch on the level-1 slab and of the K2 64-pair ICP
    launch on the level-2 slab (tile 1024); and of each, the scene points
    and normals the slab holds and the cell the JAX package gives an
    engine built for that query (its ``build_index`` call)."""
    from rescan_tpu_torch import config
    from rescan_tpu_torch.core.pointcloud import PointCloud
    from rescan_tpu_torch.utils import synthetic
    from rescan_tpu_torch.ops import icp, score, search
    from rescan_tpu_torch.sequences import SEQ_NAME

    gt = os.path.join(root, SEQ_NAME, "gt_segmentation")
    scene = PointCloud.from_ply(os.path.join(gt, "scan_001.ply"))
    base = PointCloud.from_ply(os.path.join(gt, "scan_000.ply"))
    L0 = base.levels[0]
    planar = {synthetic.NYU40_CLASSES.index(c) for c in ("wall", "floor")}
    uids = np.unique(L0["instance_ids"][~np.isin(L0["class_ids"],
                                                 list(planar))])
    slab1, sq, sqn, obj, c = _scoring_launch(cuda, scene, base, int(uids[0]))

    slab2 = search.build_index(scene.pos(2), config.REFINE_ICP_MAX_DIST,
                               normals=scene.nrm(2), tile=1024, device=cuda)
    rng = np.random.default_rng(0)
    B = ICP_PAIRS
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

    return {
        "K1 scoring": ("gated_min", slab1, sq, sqn, 0.1,
                       score.SCORE_COS_GATE, False),
        "K2 ICP": ("nearest_gated", slab2, iq, iqn, 0.1,
                   icp.cos_gate_of(np.deg2rad(60.0)), False)}, {
        "K1 scoring": (scene.pos(1), scene.nrm(1),
                       config.SCORE_SEARCH_RADII[1]),
        "K2 ICP": (scene.pos(2), scene.nrm(2), config.REFINE_ICP_MAX_DIST)}


def _scoring_launch(cuda, scene, base, uid: int, built=None):
    """The K1 scoring launch the pipeline makes for the object ``uid`` of
    ``base`` (centred on its centroid at floor height, as the prior holds
    it) over ``scene``: (the scene's level-1 index, as ``build_index``
    gives it, the launch's MAX_QUERIES_PER_LAUNCH queries and normals,
    the object, its centre). The queries are the object's level-4 points
    under the hypotheses that pass the occupancy bound, taken in turn.
    ``built``: a dict that keeps the index and the occupancy grid of
    ``scene`` from one call to the next."""
    from rescan_tpu_torch import config
    from rescan_tpu_torch.ops import score, search
    from rescan_tpu_torch.pipeline import pose_proposal
    obj = base.extract_by_ids(0, "instance_ids", [uid], compute_levels=True)
    c = obj.centroid(0).copy()
    c[1] = 0.0
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = -c
    obj.transform(T)

    built = {} if built is None else built
    if "index" not in built:
        built["index"] = search.build_index(
            scene.pos(1), config.SCORE_SEARCH_RADII[1],
            normals=scene.nrm(1), device=cuda)
        built["occ"] = pose_proposal.SceneOccupancy(
            scene.pos(1), 0.1, scene_nrm=scene.nrm(1))
    index, occ = built["index"], built["occ"]
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
    return index, sq, sqn, obj, c


def _studio_set_row(cuda, work: str) -> dict:
    """The split index at the size the main path gives it: the studio
    cell's first scan (scanbench's studio-6x6-10obj, levels built on the
    card), whose level 1 is past ``MAX_SLAB_COLS * 0.94`` points, so
    ``build_index`` makes a SlabSet, and its largest scoring launch (the
    bed's, MAX_QUERIES_PER_LAUNCH queries). K1 over the set on the card
    (a launch a part, merged on the card) against the plain version over
    the same parts merged by a strict '<' on d2 in part order, bit for
    bit; the pairs each part's pruning evaluates, beside those of one
    slab of the same points (no split: every d2 about the whole scan's
    centre, as the port built it before the split); the set's and the one
    slab's kernel times in turns (set, slab, slab, set); and how many
    queries one slab answers otherwise (found or not, d2 bits). Then a
    full launch of one object of each other class, set against one slab:
    times in turns and the pairs each evaluates."""
    from rescan_tpu_torch.core.pointcloud import PointCloud
    from rescan_tpu_torch.ops import gnn, score
    from scanbench import scenes
    with open(os.path.join(HERE, "scanbench", "configs",
                           "studio-6x6-10obj.json")) as f:
        cfg = json.load(f)
    room = scenes.room_of(cfg)
    path = os.path.join(work, "studio.ply")
    scenes.write_ply(path, scenes.scene_mesh(room, cfg["mesh_resolution"]))
    scene = PointCloud.from_ply(path, device=cuda)
    bed = scenes.FIRST_OBJECT_ID + [b.cls for b in room.objects].index("bed")
    built = {}
    sset, sq, sqn, _, _ = _scoring_launch(cuda, scene, scene, bed, built)
    if not isinstance(sset, gnn.SlabSet) or len(sset.slabs) < 2:
        raise SystemExit("[kernels] FAIL studio set: the studio's level-1 "
                         "index is no SlabSet of 2 or more parts")
    args = (sq, sqn, 0.1, score.SCORE_COS_GATE, False)
    parts = len(sset.slabs)

    def plain():
        d2 = dot = None
        for part in sset.slabs:
            d, t = gnn.gated_min_ref(part, *args)
            if d2 is None:
                d2, dot = d, t
                continue
            better = d < d2
            dot = torch.where(better, t, dot)
            d2 = torch.minimum(d2, d)
        return d2, dot

    def kern():
        return gnn.gated_min(sset, *args)

    n1 = _launched("gated_min")
    got = kern()
    if _launched("gated_min") - n1 != parts:
        raise SystemExit(f"[kernels] FAIL studio set: a search of {parts} "
                         f"parts made {_launched('gated_min') - n1} launches")
    want = plain()
    _, e = _compare("K1 studio set", got, want)
    pos = scene.pos(1)
    one = gnn.build_sorted_slab(pos, scene.nrm(1), device=cuda,
                                orig_index=np.arange(len(pos)))

    def kern_one():
        return gnn.gated_min(one, *args)

    single = kern_one()
    found_off = int((torch.isfinite(single[0])
                     != torch.isfinite(got[0])).sum())
    bits_off = int((single[0].view(torch.int32)
                    != got[0].view(torch.int32)).sum())
    reps = 3
    t_set = [queued_ms(kern, reps)[0]]
    t_one = [kernel_ms(kern_one, "gated_min", reps)]
    t_one.append(kernel_ms(kern_one, "gated_min", reps))
    t_set.append(queued_ms(kern, reps)[0])
    per_part = [gnn.pair_counts(part, *args) for part in sset.slabs]
    c_one = gnn.pair_counts(one, *args)
    c_set = {k: sum(c[k] for c in per_part) for k in per_part[0]}
    row = {"queries": int(sq.shape[0]), "points": len(pos),
           "parts": [s.n_valid for s in sset.slabs],
           "tiles": [s.tile_bounds.shape[0] for s in sset.slabs],
           "one_slab_tiles": one.tile_bounds.shape[0],
           "ms": min(t_set), "ms_runs": t_set, "one_slab_ms": min(t_one),
           "one_slab_ms_runs": t_one, "timing": TIMING,
           "found": int(torch.isfinite(want[0]).sum()),
           "one_slab_found_off": found_off, "one_slab_d2_bits_off": bits_off,
           "max_abs_err": e, "pairs": c_set, "per_part_pairs": per_part,
           "one_slab_pairs": c_one}
    say("kernels", f"studio set: {row['queries']} queries (the bed's "
        f"scoring launch) on {len(pos)} level-1 points in {parts} parts "
        f"{row['parts']} (tiles {row['tiles']}, one slab "
        f"{row['one_slab_tiles']}), {row['found']} found, 0 mismatches "
        f"against the plain version over the parts; set {min(t_set):.4f} "
        f"ms (runs {[round(t, 4) for t in t_set]}), one slab "
        f"{min(t_one):.4f} ms (runs {[round(t, 4) for t in t_one]}); "
        f"pairs evaluated {c_set['run_pairs']} (parts "
        f"{[c['run_pairs'] for c in per_part]}; one slab "
        f"{c_one['run_pairs']}), whole near tiles {c_set['tile_pairs']} "
        f"(one slab {c_one['tile_pairs']}), within r {c_set['in_radius']} "
        f"(one slab {c_one['in_radius']}); one slab answers {found_off} "
        f"queries otherwise in found, {bits_off} in d2's bits")
    row["classes"] = {"bed": {"ms": row["ms"],
                              "one_slab_ms": row["one_slab_ms"],
                              "run_pairs": c_set["run_pairs"],
                              "one_slab_run_pairs": c_one["run_pairs"]}}
    classes = [b.cls for b in room.objects]
    for cls in dict.fromkeys(classes):
        if cls == "bed":
            continue
        uid = scenes.FIRST_OBJECT_ID + classes.index(cls)
        _, q, qn, _, _ = _scoring_launch(cuda, scene, scene, uid, built)
        a = (q, qn) + args[2:]
        t_s = [queued_ms(lambda: gnn.gated_min(sset, *a), reps)[0]]
        t_o = [kernel_ms(lambda: gnn.gated_min(one, *a), "gated_min", reps)]
        t_o.append(kernel_ms(lambda: gnn.gated_min(one, *a), "gated_min",
                             reps))
        t_s.append(queued_ms(lambda: gnn.gated_min(sset, *a), reps)[0])
        rp = sum(gnn.pair_counts(part, *a)["run_pairs"]
                 for part in sset.slabs)
        rp_one = gnn.pair_counts(one, *a)["run_pairs"]
        row["classes"][cls] = {"ms": min(t_s), "one_slab_ms": min(t_o),
                               "run_pairs": rp, "one_slab_run_pairs": rp_one}
        say("kernels", f"studio set, the {cls}'s launch ({q.shape[0]} "
            f"queries): set {min(t_s):.4f} ms, one slab {min(t_o):.4f} ms; "
            f"pairs evaluated {rp}, one slab {rp_one}")
    print(json.dumps({"bench_launch": {"K1 studio set": row}}), flush=True)
    return row


def _bound(kind, n_points, m, pairs_in_r, flop_per_pair=FLOP_PER_PAIR):
    """(bound ms, what sets it): the bytes the function must move over
    HBM3's rate, against the FP32 work of the pairs within r over the FP32
    peak. Bytes: each query's position and normal read (24 B) and its
    outputs written (d2 and dot, 8 B; K2 adds the index, 4 B), and each
    valid slab point's position and normal read (24 B; K2 adds its
    original index, 4 B). Padding columns and the kernel's own tables
    (tile and run bounds) are the kernel's choice, not the function's."""
    k2 = kind == "nearest_gated"
    bytes_ = m * (24 + (12 if k2 else 8)) + n_points * (28 if k2 else 24)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = pairs_in_r * flop_per_pair / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(cuda, bench_root) -> dict:
    from rescan_tpu_torch.ops import gnn, icp, score

    rng = np.random.default_rng(1)
    n, m = 200_000, 1_000_003          # no multiple of the 128-query block
    pts = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    pts[n // 2:n // 2 + 5000] = pts[:5000]       # duplicates force ties
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = rng.uniform(0, 4, (m, 3)).astype(np.float32)
    q = q[gnn.morton_order(q)]   # compact query blocks, as callers make
    q[-1000:] = gnn.FAR          # the block at m - 1000 mixes real and far
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

    err.update(_engine_random(cuda, pts, nrm, qt, qnt))

    launches, clouds = _bench_queries(cuda, bench_root)
    rows = {what: _bench_row(what, *launch)
            for what, launch in launches.items()}
    for row in rows.values():
        err[row["kind"]] = max(err[row["kind"]], row["max_abs_err"])
    engines = {what: _engine_bench(what, launch, clouds[what],
                                   rows[what]["ms"])
               for what, launch in launches.items()}
    for er in engines.values():
        for k, row in er.items():
            err[k] = max(err[k], row["max_abs_err"])
    _residency(cuda, launches["K1 scoring"])
    _studio_set_row(cuda, bench_root)
    first = {"gated_min": "K1 scoring", "nearest_gated": "K2 ICP"}
    rows = {k: rows[v] for k, v in first.items()}
    # the engines' largest launch: scoring's
    rows.update(engines["K1 scoring"])
    rows["engine_launches"] = engines
    err["pairsum"] = _pairsum_random(cuda)
    n_pts = launches["K2 ICP"][2].shape[0] // ICP_PAIRS
    icp_rows = [_pairsum_row(cuda, r, ICP_PAIRS, n_pts) for r in (3, 4)]
    # the longest sums the path runs: the refine-to-scene launch of 30
    # pairs and a one-pair augmentation launch, 32768 points each
    icp_rows += [_pairsum_row(cuda, 4, 30, 32768),
                 _pairsum_row(cuda, 4, 1, 32768, single=True)]
    err["pairsum"] = max([err["pairsum"]] + [r["max_abs_err"]
                                             for r in icp_rows])
    rows["pairsum"] = icp_rows[1]
    rows["fma"] = _fma_row(cuda)
    rows["score_terms"] = _score_terms_row(cuda, launches["K1 scoring"])
    _xla_math_rows(cuda)
    rows["poisson_levels"] = _levels_row(cuda, bench_root)
    err["poisson_levels"] = 0.0
    return {"err": err, "rows": rows}


def _levels_row(cuda, root) -> dict:
    """The LoD levels' card pass (ops/levels.py) on the bench scan's
    level 0 at the four voxels, as a rescan's ingest builds them: index for
    index against the native pass, then card, plain, plain, card timed in
    this call. A card call waits on the card (the points' box, the
    worklists' lengths, the indices' copy back), so no spin can hide the
    host's work: it is timed by CUDA events around whole calls, which is
    what a rescan pays; the native pass by the host clock. The bound: the
    positions read once (12 B a point) and the kept indices written once
    (4 B each) at HBM3's rate."""
    from rescan_tpu_torch import config
    from rescan_tpu_torch.core.pointcloud import PointCloud
    from rescan_tpu_torch.ops import levels
    from rescan_tpu_torch.sequences import SEQ_NAME
    path = os.path.join(root, SEQ_NAME, "gt_segmentation", "scan_001.ply")
    pts = PointCloud.from_ply(path, compute_levels=False).pos(0)
    voxels = config.LEVEL_VOXEL_SIZES[1:]
    reps = 5

    def kern():
        return levels.poisson_levels(pts, voxels, cuda)

    def plain():
        return levels.poisson_levels(pts, voxels, None)

    _reset_counts()
    got = kern()
    rounds = list(levels.ROUNDS)
    want, t0 = _timed(plain)
    bad = [v for v, g, w in zip(voxels, got, want)
           if not np.array_equal(g, w)]
    if bad:
        raise SystemExit(f"[kernels] FAIL poisson_levels: the card's "
                         f"indices differ from the native pass's at voxels "
                         f"{bad}")
    t_k = [cuda_ms(kern, reps)]
    t_p = [t0 * 1e3, _timed(plain)[1] * 1e3]
    t_k.append(cuda_ms(kern, reps))
    launches, plain_calls = _counts()
    calls = 1 + 2 * (reps + 1)
    if (launches["poisson_levels"] != calls
            or plain_calls["poisson_levels"] != 2 * len(voxels)):
        raise SystemExit(f"[kernels] FAIL poisson_levels: {calls} card and "
                         f"2 native pyramids made {launches['poisson_levels']}"
                         f" card calls and {plain_calls['poisson_levels']} "
                         f"native passes")
    kept = [len(g) for g in got]
    n_bytes = 12 * len(pts) + 4 * sum(kept)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    ms = min(t_k)
    row = {"ms": ms, "ms_runs": t_k, "timing": "CUDA events around whole "
           "calls, each ending in its copy of the indices to the host",
           "plain_ms": min(t_p), "plain_ms_runs": t_p,
           "plain_timing": "host clock around one call",
           "bound_ms": bound, "bound_by": "bytes",
           "share_of_bound": bound / ms, "points": len(pts), "kept": kept,
           "rounds": rounds, "voxels": list(voxels)}
    say("kernels", f"poisson_levels on the bench scan ({len(pts)} points, "
        f"voxels {list(voxels)}): kept {kept} in rounds {rounds}, index for "
        f"index the native pass's; card {ms:.3f} ms a pyramid (runs "
        f"{[round(t, 3) for t in t_k]}), native {min(t_p):.1f} ms; bound "
        f"{bound:.5f} ms (bytes), card at {bound / ms:.5f} of it")
    print(json.dumps({"bench_launch": {"poisson_levels": row}}), flush=True)
    return row


def _events_ms(fn):
    """(fn(), milliseconds) of one call by CUDA events around it, the
    host's work and any wait on the card included (plain versions)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _engine_random(cuda, pts, nrm, qt, qnt) -> dict:
    """The grid kernels (radius_knn at K = 8 and 16; nearest_gated, both
    gate kinds) and the dense kernel against their plain versions on
    phase 3's random fixture: duplicated points, far queries, a query
    count that is no multiple of the CTA. Returns each kernel's largest
    |kernel - plain| over finite values."""
    from rescan_tpu_torch.ops import dense_nn, hashgrid, score
    err = dict.fromkeys(ENGINE_KERNELS, 0.0)
    dense = dense_nn.build_dense_index(pts, nrm, device=cuda)
    for radius, gate, use_abs in ((0.1, score.SCORE_COS_GATE, False),
                                  (0.075, -1.0, True)):
        grid = hashgrid.build_grid(pts, radius, normals=nrm, device=cuda)
        args = (qt, qnt, radius, gate, use_abs)
        _, e = _compare("grid nearest_gated random",
                        hashgrid.nearest_gated(grid, *args),
                        hashgrid.nearest_gated_ref(grid, *args))
        err["grid_nearest_gated"] = max(err["grid_nearest_gated"], e)
        got = dense_nn.nearest_gated_dense(dense, *args)
        _, e = _compare("dense random", got,
                        dense_nn.nearest_gated_dense_ref(dense, *args))
        err["dense_nearest"] = max(err["dense_nearest"], e)
        say("kernels", f"grid and dense random r={radius} abs={use_abs}: "
            f"cap {grid.cap}, {int((got[0] >= 0).sum())}/{qt.shape[0]} "
            f"found, 0 mismatches")
    for k in hashgrid.KERNEL_K:
        got = hashgrid.radius_knn(grid, qt, 0.075, k)
        _, e = _compare(f"grid radius_knn random K={k}", got,
                        hashgrid.radius_knn_ref(grid, qt, 0.075, k))
        err["grid_radius_knn"] = max(err["grid_radius_knn"], e)
        say("kernels", f"grid radius_knn random K={k} r=0.075: "
            f"{int(got[2].sum())} neighbours, {int((got[2] == k).sum())} "
            f"queries full, 0 mismatches")
    return err


def _engine_bench(what, launch, cloud, k_ms, phase="kernels") -> dict:
    """The grid and dense kernels on the queries of one bench launch of
    K1/K2, each engine built on the launch's scene points (the grid with
    the JAX package's cell for that query): bit for bit against the plain
    versions; kernel, plain, and K1/K2's ms on the same queries; the
    pairs each kernel evaluates and those within r; the bound (as
    ``_bound``, with the index written: both engines return it). Prints
    a line per engine; returns {kernel: row}."""
    from rescan_tpu_torch.ops import dense_nn, hashgrid
    _, _, q, qn, radius, gate, use_abs = launch
    pts, nrm, cell = cloud
    grid = hashgrid.build_grid(pts, cell, normals=nrm, device=q.device)
    dense = dense_nn.build_dense_index(pts, nrm, device=q.device)
    args = (q, qn, radius, gate, use_abs)
    m, n = q.shape[0], len(pts)
    reps = 3 if m > 1_000_000 else 10
    rows = {}
    for name, kern, plain in (
            ("grid_nearest_gated",
             lambda: hashgrid.nearest_gated(grid, *args),
             lambda st: hashgrid.nearest_gated_ref(grid, *args, stats=st)),
            ("dense_nearest",
             lambda: dense_nn.nearest_gated_dense(dense, *args),
             lambda st: dense_nn.nearest_gated_dense_ref(dense, *args,
                                                         stats=st))):
        st = {}
        want, t_p = _events_ms(lambda: plain(st))
        _, e = _compare(f"{name} {what}", kern(), want)
        # kernel, kernel: the plain version ran once, before them
        t_k = [kernel_ms(kern, name, reps), kernel_ms(kern, name, reps)]
        bound, by = _bound("nearest_gated", n, m, st["in_radius"])
        ms = min(t_k)
        say(phase, f"bench {what} launch on the {name.split('_')[0]} engine"
            f" (cell {cell}" + (f", cap {grid.cap}" if name.startswith(
                "grid") else "") + f"): {m} queries on {n} points, "
            f"{int((want[0] >= 0).sum())} found, 0 mismatches; kernel "
            f"{ms:.4f} ms (runs {[round(t, 4) for t in t_k]}), plain "
            f"{t_p:.3f} ms, K1/K2 on the same queries {k_ms:.4f} ms; pairs "
            f"evaluated {st['pairs']}, within r {st['in_radius']}; bound "
            f"{bound:.5f} ms ({by}), kernel at {bound / ms:.5f} of it")
        rows[name] = {"queries": m, "points": n, "cell": cell, "ms": ms,
                      "ms_runs": t_k, "timing": TIMING, "plain_ms": t_p,
                      "plain_timing": "CUDA events around one call",
                      "k1_k2_ms": k_ms, "bound_ms": bound, "bound_by": by,
                      "share_of_bound": bound / ms, "max_abs_err": e,
                      "pairs": st["pairs"], "in_radius": st["in_radius"]}
    print(json.dumps({"engine_launch": {what: rows}}), flush=True)
    return rows


def _pairsum_random(cuda) -> float:
    """pairsum against its plain version on random rows with a fifth of
    the entries zero: every kind, over the whole axis and chained over
    runs of points as the mesh's sp slots chain them; the states bit for
    bit. Returns max |kernel - plain| of the sums."""
    from rescan_tpu_torch.ops import pairsum
    from rescan_tpu_torch.ops.pairsum import (BLOCKED, BLOCKED_TAIL, CHAIN,
                                              FOLDED, FOLDED_TAIL, LANES,
                                              LANES_TAIL, ONE, WINDOW)
    spec = [(WINDOW, 0, ONE), (CHAIN, 0, 1), (BLOCKED, 1, 2),
            (WINDOW, 3, ONE), (CHAIN, 2, 3), (LANES, 0, 1),
            (LANES_TAIL, 2, 3), (LANES_TAIL, 1, ONE), (BLOCKED_TAIL, 0, 3)]
    small = [(WINDOW, 0, ONE), (CHAIN, 0, 1), (LANES_TAIL, 1, 2),
             (BLOCKED_TAIL, 2, 3)]
    rng = np.random.default_rng(2)
    err = 0.0
    for n, parts in ((128, 1), (1024, 1), (2048, 1), (4096, 1), (4096, 4),
                     (8192, 2), (16384, 1), (32768, 4)):
        x = torch.from_numpy((rng.normal(size=(7, n, 4))
                              * (rng.random((7, n, 4)) < 0.8))
                             .astype(np.float32)).to(cuda)
        m = n // parts
        # the kernel's big shape (9 sums) and its small one (4 sums)
        for sp_ in (spec, small):
            sk = sp = None
            for k in range(parts):
                xs = x[:, k * m:(k + 1) * m].contiguous()
                sk = pairsum.pairsum(xs, sp_, k * m, n, sk)
                sp = pairsum.pairsum_ref(xs, sp_, k * m, n, sp)
            _, e = _compare(f"pairsum random n={n} in {parts} runs, "
                            f"{len(sp_)} sums",
                            (pairsum.totals(sk, sp_, n), sk),
                            (pairsum.totals(sp, sp_, n), sp))
            err = max(err, e)
    # the one-pair kinds of 128 and 256 points: the whole axis at once
    for n in (128, 256):
        x = torch.from_numpy((rng.normal(size=(7, n, 4))
                              * (rng.random((7, n, 4)) < 0.8))
                             .astype(np.float32)).to(cuda)
        fspec = [(FOLDED, 0, 1), (FOLDED_TAIL, 2, 3), (FOLDED_TAIL, 1, ONE),
                 (WINDOW, 3, ONE), (BLOCKED, 0, 2)]
        sk, sp = pairsum.pairsum(x, fspec), pairsum.pairsum_ref(x, fspec)
        _, e = _compare(f"pairsum FOLDED n={n}",
                        (pairsum.totals(sk, fspec, n), sk),
                        (pairsum.totals(sp, fspec, n), sp))
        err = max(err, e)
    say("kernels", "pairsum random rows (every kind, in the kernel's big and "
        "small shapes; 128 to 32768 points, whole and in 2 or 4 chained "
        "runs; the one-pair FOLDED kinds at 128 and 256): 0 mismatches")
    return err


ICP_PAIRS = 64


def _pairsum_row(cuda, round_: int, b: int, n: int,
                 single: bool = False) -> dict:
    """One of the ICP step's two heavy rounds of sums (3: w, w q, w p2;
    4: the 6x6 system, b and the error) at b pairs of n points, laid out
    and specified as ops/icp.py lays them out (``single``: in the orders
    of a launch of one pair), on random rows with a fifth of the weights
    zero: kernel against plain version bit for bit, both timed, the
    library's Gram product of the same columns (torch.bmm, one call), the
    bound and the CHAIN sums' latency floor; prints one line."""
    from rescan_tpu_torch.ops import icp, pairsum
    rng = np.random.default_rng(round_)
    spec = icp._specs(n, single)[round_ - 3]
    k = 7 if round_ == 3 else 15
    x = rng.normal(size=(b, n, k)).astype(np.float32)
    x[rng.random((b, n)) < 0.2] = 0.0
    x = torch.from_numpy(x).to(cuda)
    q = len(spec)

    def kern():
        return pairsum.pairsum(x, spec)

    def plain():
        return pairsum.pairsum_ref(x, spec)

    _, e = _compare(f"pairsum ICP round {round_}", (kern(),), (plain(),))
    # kernel, plain, plain, kernel
    t_k = [kernel_ms(kern, "pairsum")]
    t_p = [cuda_ms(plain, 1)]
    t_p.append(cuda_ms(plain, 1))
    t_k.append(kernel_ms(kern, "pairsum"))
    t_w = cuda_ms(kern, 10)
    xt = x.transpose(1, 2)
    t_lib = queued_ms(lambda: torch.bmm(xt, x))[0]
    # the function reads every entry once and writes each pair's sums;
    # its work is one FMA (2 flops) per point per sum
    t_bytes = (x.numel() + b * q) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = b * n * q * 2 / FP32_FLOP_PER_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
    # XLA's order holds a CHAIN sum (one segment over the whole axis) to n
    # dependent FMAs, whatever the parallelism
    chain = n * FMA_LATENCY_CYCLES / (sm_clock_mhz() * 1e6) * 1e3
    ms = min(t_k)
    say("kernels", f"pairsum ICP round {round_} at {b} pairs x {n} points "
        f"({q} sums{', one-pair orders' if single else ''}): 0 mismatches; "
        f"kernel {ms:.4f} ms (runs {[round(t, 4) for t in t_k]}; with the "
        f"host's work between calls {t_w:.4f} ms), plain {min(t_p):.3f} ms, "
        f"torch.bmm Gram product {t_lib:.4f} ms (same call, timed alike); "
        f"bound {bound:.5f} ms ({by}), kernel at {bound / ms:.5f} of "
        f"it; the CHAIN sums' latency floor ({n} dependent FMAs of "
        f"{FMA_LATENCY_CYCLES} cycles at {sm_clock_mhz():.0f} MHz) "
        f"{chain:.5f} ms, kernel at {chain / ms:.5f} of it")
    row = {"kind": "pairsum", "round": round_, "pairs": b, "points": n,
           "single": single, "sums": q, "ms": ms, "ms_runs": t_k,
           "timing": TIMING, "wrapper_ms": t_w, "plain_ms": min(t_p),
           "plain_ms_runs": t_p, "library_ms": t_lib, "bound_ms": bound,
           "bound_by": by, "share_of_bound": bound / ms, "chain_ms": chain,
           "max_abs_err": e}
    print(json.dumps({"bench_launch": {
        f"pairsum ICP round {round_}, {b} x {n}": row}}), flush=True)
    return row


def _timed_row(what, kern, plain, library, n_bytes, n_flops, counter,
               phase="kernels", **extra) -> dict:
    """kernel, plain, plain, kernel times of one launch in this call (the
    kernel by ``kernel_ms``, its launches counted as ``counter``; the
    plain version by ``cuda_ms``), the kernel with the host's work between
    calls, the library call's (``queued_ms``, as the kernel's) and the
    bound (bytes over HBM3's rate against FP32 operations over the peak);
    prints one line."""
    t_k = [kernel_ms(kern, counter)]
    t_p = [cuda_ms(plain, 2)]
    t_p.append(cuda_ms(plain, 2))
    t_k.append(kernel_ms(kern, counter))
    t_w = cuda_ms(kern, 10)
    t_lib = queued_ms(library)[0] if library else None
    bound, by = max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (n_flops / FP32_FLOP_PER_S * 1e3, "operations"))
    ms = min(t_k)
    say(phase, f"{what}: kernel {ms:.4f} ms (runs "
        f"{[round(t, 4) for t in t_k]}; with the host's work between calls "
        f"{t_w:.4f} ms), plain {min(t_p):.4f} ms, library "
        + (f"{t_lib:.4f} ms" if t_lib else "none")
        + f" (same call, timed alike); bound {bound:.5f} ms ({by}), kernel "
        f"at {bound / ms:.5f} of it")
    row = {"ms": ms, "ms_runs": t_k, "timing": TIMING, "wrapper_ms": t_w,
           "plain_ms": min(t_p), "plain_ms_runs": t_p, "library_ms": t_lib,
           "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms,
           **extra}
    print(json.dumps({"bench_launch": {what: row}}), flush=True)
    return row


def _fma_row(cuda) -> dict:
    """The largest fma_chains launch of the main path at its shape: the
    scoring launch's two transforms (R p + t and R n of 4,194,304 query
    points, R and t broadcast over each hypothesis's points), held to the
    plain chains bit for bit, beside torch.addcmul over the same six
    output columns."""
    from rescan_tpu_torch.ops import icp, pairsum, score
    rng = np.random.default_rng(7)
    pp = 512
    h = score.MAX_QUERIES_PER_LAUNCH // pp
    ang = rng.uniform(0, 2 * np.pi, h)
    R = np.zeros((h, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 2], R[:, 2, 0], R[:, 2, 2] = (
        np.cos(ang), np.sin(ang), -np.sin(ang), np.cos(ang))
    R[:, 1, 1] = 1
    R, t, pts, nrm = (torch.from_numpy(a).to(cuda) for a in (
        R, rng.uniform(-2, 2, (h, 3)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (h, pp, 3)).astype(np.float32),
        rng.normal(size=(h, pp, 3)).astype(np.float32)))

    def chains():
        def terms(v):
            return [(R[:, None, :, j], v[..., j, None]) for j in range(3)]
        return [pairsum.Chain(terms(pts), add=t[:, None, :]),
                pairsum.Chain(terms(nrm))]

    got = icp._transform(R, t, pts, nrm)
    want = [c.plain(pts.shape) for c in chains()]
    _, e = _compare("fma chains, scoring transforms", got, want)
    a, b, c = (torch.from_numpy(rng.normal(size=(h, pp, 6)).astype(
        np.float32)).to(cuda) for _ in "abc")
    n = pts.numel()
    # read: the points and normals (and R, t per hypothesis); written: the
    # two transforms. 3 fmas and an add (7 flops) per q entry, 3 fmas (5)
    # per qn entry
    return _timed_row(
        "fma chains, scoring transforms (R p + t, R n of "
        f"{h} x {pp} points, one launch)",
        lambda: icp._transform(R, t, pts, nrm),
        lambda: [ch.plain(pts.shape) for ch in chains()],
        lambda: torch.addcmul(c, a, b),
        (2 * n + 2 * n + h * 12) * 4, n * 12, "fma",
        max_abs_err=e, entries=2 * n)


def _score_terms_row(cuda, launch) -> dict:
    """scoring's per-point terms at the bench scoring launch (K1's
    4,194,304 queries), held to per_point_ref bit for bit, beside
    torch.addcmul over the same entries."""
    from rescan_tpu_torch.ops import lu6, score, search
    _, slab, bq, bqn, radius, gate, use_abs = launch
    d2, dot, found = search.gated_min(slab, bq, bqn, radius, gate, use_abs)
    m = bq.shape[0]
    mask = torch.ones(m, dtype=torch.bool, device=cuda)
    mask[m - m // 16:] = False
    got = score.per_point(d2, dot, found, mask, 0.1)
    want = score.per_point_ref(d2, dot, found, mask, 0.1)
    if not lu6.same_bits(got, want):
        raise SystemExit("[kernels] FAIL score terms: differ from "
                         "per_point_ref")
    fin = torch.isfinite(got) & torch.isfinite(want)
    e = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    a = torch.rand(m, device=cuda)
    # d2, dot (4 B each), found, mask (1 B each) read, the term written;
    # per found point the two exps and the arccos (~60 flops)
    return _timed_row(
        f"score terms, bench scoring launch ({m} points, "
        f"{int(found.sum())} found)",
        lambda: score.per_point(d2, dot, found, mask, 0.1),
        lambda: score.per_point_ref(d2, dot, found, mask, 0.1),
        lambda: torch.addcmul(a, d2, dot), m * 14,
        int(found.sum()) * 60, "score_terms", max_abs_err=e,
        entries=m)


def _xla_math_rows(cuda) -> None:
    """xla_math_kernel's three operations against the plain versions on
    1,048,576 arguments over the pipeline's domains and beyond, bit for
    bit (a NaN equal to any NaN), each beside torch's own function."""
    from rescan_tpu_torch.ops import lu6, xla_math
    rng = np.random.default_rng(9)
    n = 1 << 20
    x = torch.from_numpy(np.concatenate([
        rng.uniform(-5, 0, n // 4), rng.uniform(0, 1, n // 4),
        rng.uniform(-0.3, 0.3, n // 4),
        rng.uniform(-1, 1, n // 4) * 10.0 ** rng.uniform(-8, 6, n // 4)])
        .astype(np.float32)).to(cuda)
    ops = {"exp": (xla_math.exp, xla_math.exp_ref, torch.exp),
           "arccos": (xla_math.acos, xla_math.acos_ref, torch.acos),
           "sincos": (xla_math.sincos,
                      lambda v: torch.stack([xla_math.cos_ref(v),
                                             xla_math.sin_ref(v)]), None)}
    for name, (kern, plain, lib) in ops.items():
        if not lu6.same_bits(kern(x), plain(x)):
            raise SystemExit(f"[kernels] FAIL xla_math {name}: differs from "
                             f"the plain version")
        _timed_row(f"xla_math {name}, {n} arguments (0 mismatches)",
                   lambda: kern(x), lambda: plain(x),
                   (lambda: lib(x)) if lib else None,
                   n * (12 if name == "sincos" else 8), n * 40,
                   "xla_math")


def _bench_row(what, kind, slab, bq, bqn, radius, gate, use_abs,
               phase="kernels") -> dict:
    """One launch of the main path's shape: kernel against plain version
    bit for bit, both timed in turns within this call, the pair counts of
    the kernel's pruning and the bound; prints one line."""
    from rescan_tpu_torch.ops import gnn
    args = (slab, bq, bqn, radius, gate, use_abs)
    kern = getattr(gnn, kind)
    plain = getattr(gnn, kind + "_ref")
    p = plain(*args)
    _, e = _compare(what, kern(*args), p)
    # kernel, plain, plain, kernel
    reps = 3 if bq.shape[0] > 1_000_000 else 10
    t_k = [kernel_ms(lambda: kern(*args), kind, reps)]
    t_p = [cuda_ms(lambda: plain(*args), 1)]
    t_p.append(cuda_ms(lambda: plain(*args), 1))
    t_k.append(kernel_ms(lambda: kern(*args), kind, reps))
    c = gnn.pair_counts(*args)
    bound, by = _bound(kind, slab.n_valid, bq.shape[0], c["in_radius"])
    ms = min(t_k)
    found = (p[0] >= 0) if kind == "nearest_gated" else torch.isfinite(p[0])
    say(phase, f"bench {what} launch: {bq.shape[0]} queries on "
        f"{slab.n_valid} points (tile {slab.tile}, r {radius}), "
        f"{int(found.sum())} found, 0 mismatches; kernel {ms:.4f} ms "
        f"(runs {[round(t, 4) for t in t_k]}), plain {min(t_p):.3f} ms; "
        f"pairs evaluated {c['run_pairs']} (a walk over whole near tiles "
        f"{c['tile_pairs']}), within r {c['in_radius']}; bound "
        f"{bound:.5f} ms ({by}), kernel at {bound / ms:.5f} of it")
    row = {"kind": kind, "queries": int(bq.shape[0]),
           "slab_points": slab.n_valid, "ms": ms, "ms_runs": t_k,
           "timing": TIMING,
           "plain_ms": min(t_p), "plain_ms_runs": t_p, "bound_ms": bound,
           "bound_by": by, "share_of_bound": bound / ms, "max_abs_err": e,
           **c}
    print(json.dumps({"bench_launch": {what: row}}), flush=True)
    return row


def _residency(cuda, launch) -> None:
    """K1 on the scoring launch at several preferred shared-memory
    carveouts, each setting how many of its CTAs fit on an SM (read back
    from the occupancy calculator); the default carveout first and last.
    Every run is held to the first bit for bit."""
    from rescan_tpu_torch.ops import gnn
    kind, slab, bq, bqn, radius, gate, use_abs = launch
    args = (slab, bq, bqn, radius, gate, use_abs)
    want = gnn.gated_min(*args)
    got = []
    try:
        for carveout in (-1, 100, 50, 25, 12, -1):
            info = gnn.kernel_info(False, use_abs, cuda, carveout)
            _compare(f"K1 at carveout {carveout}", gnn.gated_min(*args),
                     want)
            ms = cuda_ms(lambda: gnn.gated_min(*args), 3)
            got.append({"carveout": carveout,
                        "ctas_per_sm": info["ctas_per_sm"], "ms": ms})
    finally:
        gnn.kernel_info(False, use_abs, cuda, -1)
    say("kernels", "K1 scoring launch by residency (carveout %, CTAs per "
        "SM, ms): " + "; ".join(f"{g['carveout']}, {g['ctas_per_sm']}, "
                                f"{g['ms']:.4f}" for g in got))
    print(json.dumps({"k1_residency": got}), flush=True)


def _run_driver(root: str, class_file: str, devices, profiles=None) -> None:
    from rescan_tpu_torch.pipeline import driver
    from rescan_tpu_torch.sequences import SEQ_NAME
    cwd = os.getcwd()
    log = io.StringIO()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(log), _host_stages():
            driver.run_sequence(SEQ_NAME, class_file, profiles=profiles,
                                devices=devices)
    finally:
        os.chdir(cwd)


# the native level passes of the two stages that take no device, as the
# JAX package's host modules they copy: seg2rsdb's bootstrap (the first
# scan's pyramid) and create_eval_files' level-1 ingest. Counted apart
# (_host_stages), so that the plain calls of _counts are the rescans'
HOST_STAGE_LEVELS = {"poisson_levels": 0}


@contextlib.contextmanager
def _host_stages():
    """Count the native level passes made inside seg2rsdb.run and
    create_eval_files.run in HOST_STAGE_LEVELS."""
    from rescan_tpu_torch.ops import levels
    from rescan_tpu_torch.pipeline import create_eval_files, seg2rsdb
    real = {m: m.run for m in (seg2rsdb, create_eval_files)}

    def counted(fn):
        def run(*a, **k):
            n0 = levels.PLAIN_CALLS["poisson_levels"]
            try:
                return fn(*a, **k)
            finally:
                HOST_STAGE_LEVELS["poisson_levels"] += (
                    levels.PLAIN_CALLS["poisson_levels"] - n0)
        return run

    for m, fn in real.items():
        m.run = counted(fn)
    try:
        yield
    finally:
        for m, fn in real.items():
            m.run = fn


def _counts():
    """(launches, plain calls) of every kernel wrapper; the levels' plain
    calls without those of the stages that take no device
    (HOST_STAGE_LEVELS)."""
    from rescan_tpu_torch.ops import dense_nn, gnn, hashgrid, levels, pairsum
    mods = (gnn, pairsum, hashgrid, dense_nn, levels)
    plain = {k: v for m in mods for k, v in m.PLAIN_CALLS.items()}
    plain["poisson_levels"] -= HOST_STAGE_LEVELS["poisson_levels"]
    return {k: v for m in mods for k, v in m.LAUNCHES.items()}, plain


def _reset_counts() -> None:
    from rescan_tpu_torch.ops import dense_nn, gnn, hashgrid, levels, pairsum
    for m in (gnn, pairsum, hashgrid, dense_nn, levels):
        m.reset_counts()
    HOST_STAGE_LEVELS["poisson_levels"] = 0


def _counted(phase: str, what: str, fn, need=PATH_KERNELS, none=()):
    """fn() with the kernel launch counts reset just before and read just
    after; fails unless every kernel in ``need`` launched, none in
    ``none`` did, and no plain version ran."""
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches, plain = _counts()
    if min(launches[k] for k in need) == 0 or any(
            launches[k] for k in none) or any(plain.values()):
        raise SystemExit(f"[{phase}] FAIL {what}: kernel launches "
                         f"{launches}, plain calls {plain}")
    return out, launches, plain


def _small_parity(phase: str, work: str, devices, grid: bool = False) -> str:
    """The small sequence through the driver on ``devices``, held to the
    committed JAX outputs; returns a summary. ``grid``: every index on
    the HashGrid (``search.build_index`` with ``prefer_dense=False``),
    whose kernels then answer every query and no slab kernel runs."""
    from rescan_tpu_torch import sequences
    from rescan_tpu_torch.ops import search
    root = os.path.join(work, f"small_{len(devices)}" + "_grid" * grid)
    class_file = sequences.write_small_sequence(root)
    t0 = time.perf_counter()
    slab = ("gated_min", "nearest_gated")
    real = search.build_index
    if grid:
        search.build_index = functools.partial(real, prefer_dense=False)
    try:
        _, launches, plain = _counted(
            phase, "small sequence",
            lambda: _run_driver(root, class_file, devices),
            need=(tuple(k for k in PATH_KERNELS if k not in slab)
                  + ("grid_nearest_gated",)) if grid else PATH_KERNELS,
            none=slab if grid else ())
    finally:
        search.build_index = real
    got = sequences.read_outputs(root)
    ref = dict(np.load(REF_NPZ))
    bad = sequences.compare_outputs(ref, got)
    if bad:
        raise SystemExit(f"[{phase}] FAIL vs "
                         f"{os.path.relpath(REF_NPZ, HERE)}: {bad}; "
                         f"{sequences.output_diffs(ref, got)}")
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
        f"{sequences.output_diffs(ref, got)}; outputs not bit-identical: "
        f"{_exact(ref, got) or 'none'}; kernel launches {launches}, plain "
        f"calls {plain}")


def phase_parity(cuda, work: str) -> dict:
    """The small sequence on the slab, then on the HashGrid, each held
    to the JAX package's committed run (its CPU engine is the HashGrid);
    returns the grid run's launches."""
    say("parity", _small_parity("parity", work, [cuda]))
    say("parity", "on the grid engine: " + _small_parity(
        "parity", work, [cuda], grid=True))
    return dict(_counts()[0])


# the recorded calls of one wrapper, one per distinct shape, at most
MAX_RECORDED = 64


def _record_path_calls():
    """Wrap pairsum.pairsum, pairsum.fma_chains, score.per_point and the
    ICP step's head and tail (icp._icp_head, icp._icp_tail) so that the
    first call of every distinct shape on the card keeps a copy of its
    inputs (the head: of every form and shape; the tail: of every pair
    count, before and after the convergence test starts; the fma chains,
    whose operands are strided views, are held to their plain chains
    right after the call instead, and keep their operands for the
    timing); every call passes on unchanged. Returns (calls, undo)."""
    from rescan_tpu_torch import config
    from rescan_tpu_torch.ops import icp, pairsum, score
    calls = {k: {} for k in PORT_KERNELS if k not in INSIDE_TAIL}
    real = {"pairsum": pairsum.pairsum, "fma": pairsum.fma_chains,
            "score_terms": score.per_point, "icp_head": icp._icp_head,
            "icp_tail": icp._icp_tail}

    def keep(name, key, make):
        if key not in calls[name] and len(calls[name]) < MAX_RECORDED:
            calls[name][key] = make()

    def rec_pairsum(x, spec, n0=0, n_total=None, state=None):
        if x.is_cuda:
            keep("pairsum", (tuple(x.shape), repr(spec), n0, n_total,
                             state is None),
                 lambda: (x.clone(), spec, n0, n_total,
                          None if state is None else state.clone()))
        return real["pairsum"](x, spec, n0, n_total, state)

    def rec_fma(chains, shape, outs=None):
        got = real["fma"](chains, shape, outs)
        key = (tuple(shape), len(chains))
        if got[0].is_cuda and key not in calls["fma"] and \
                len(calls["fma"]) < MAX_RECORDED:
            want = [c.plain(torch.Size(shape)) for c in chains]
            _, e = _compare(f"fma chains path launch {tuple(shape)}", got,
                            want)
            calls["fma"][key] = (chains, torch.Size(shape), e)
        return got

    def rec_terms(d2, dot, found, mask, sigma):
        if d2.is_cuda:
            keep("score_terms", tuple(d2.shape), lambda: (
                d2.clone(), dot.clone(), found.clone(), mask.clone(), sigma))
        return real["score_terms"](d2, dot, found, mask, sigma)

    def rec_head(form, *args):
        if args[0].is_cuda:
            keep("icp_head", (form, tuple(tuple(a.shape) for a in args
                                          if torch.is_tensor(a))),
                 lambda: (form,) + tuple(a.clone() if torch.is_tensor(a)
                                         else a for a in args))
        return real["icp_head"](form, *args)

    def rec_tail(*args):
        if args[0].is_cuda:
            keep("icp_tail", (args[0].shape[0],
                              args[-1] > config.ICP_CONVERGE_MIN_ITER),
                 lambda: tuple(a.clone() for a in args[:-1]) + args[-1:])
        return real["icp_tail"](*args)

    pairsum.pairsum, pairsum.fma_chains = rec_pairsum, rec_fma
    score.per_point, icp._icp_tail = rec_terms, rec_tail
    icp._icp_head = rec_head

    def undo():
        pairsum.pairsum, pairsum.fma_chains = real["pairsum"], real["fma"]
        score.per_point = real["score_terms"]
        icp._icp_head, icp._icp_tail = real["icp_head"], real["icp_tail"]
    return calls, undo


def _finite_err(got, want) -> float:
    fin = torch.isfinite(got) & torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _path_launches(calls) -> dict:
    """Phase 5's launches of the library's kernels on the path (pairsum,
    the fma chains, the ICP tail, the score terms; the first of every
    shape), each held to its plain version bit for bit (the fma chains
    right after their call, the others after the run); the largest
    launch of each measured against its plain version, a PyTorch call
    where there is one and the bound (pairsum: its three largest shapes,
    the kernel alone); the standalone lu6 and XLA math on the tail's
    systems and angles (``_tail_rows``). Returns {name: row} for the
    kernels line (pairsum: its max_abs_err only)."""
    from rescan_tpu_torch.ops import lu6, pairsum, score
    if not all(calls.values()):
        raise SystemExit(f"[slice] FAIL: launches recorded "
                         f"{ {k: len(v) for k, v in calls.items()} }")
    err = 0.0
    for x, spec, n0, n_total, state in calls["pairsum"].values():
        got = pairsum.pairsum(x, spec, n0, n_total, state)
        want = pairsum.pairsum_ref(x, spec, n0, n_total, state)
        _, e = _compare(f"pairsum path launch {tuple(x.shape)} n0={n0}",
                        (got,), (want,))
        err = max(err, e)
    shapes = sorted({(x.shape[0], x.shape[1], n_total or x.shape[1])
                     for x, _, _, n_total, _ in calls["pairsum"].values()},
                    key=lambda t: t[1])
    say("slice", f"pairsum: {len(calls['pairsum'])} launch shapes of the "
        f"run held to the plain version, 0 mismatches; (pairs, points, "
        f"axis) from {shapes[0]} to {shapes[-1]}, "
        f"{sum(t[2] >= 16384 for t in shapes)} of them over 16384 points "
        f"or more")
    big = sorted(calls["pairsum"].values(),
                 key=lambda c: c[0].shape[0] * c[0].shape[1])[-3:]
    timed = []
    for x, spec, n0, n_total, state in big:
        call = lambda: pairsum.pairsum(x, spec, n0, n_total, state)  # noqa: E731
        timed.append({"shape": list(x.shape), "sums": len(spec), "n0": n0,
                      "ms": kernel_ms(call, "pairsum"),
                      "wrapper_ms": cuda_ms(call, 5)})
    say("slice", "pairsum, the largest path launches (pairs, points, "
        "columns; sums): " + "; ".join(
            f"{tuple(t['shape'])}, {t['sums']} sums: {t['ms']:.4f} ms"
            for t in timed))
    rows = {"pairsum": {"max_abs_err": err, "largest": timed}}

    e_fma = max(e for _, _, e in calls["fma"].values())
    chains, shape, _ = max(calls["fma"].values(),
                           key=lambda c: c[1].numel() * len(c[0]))
    n = shape.numel() * len(chains)
    ops = {id(t): t for c in chains for t in c.operands()}
    a, b, c = (torch.rand(n, device=chains[0].terms[0][0].device)
               for _ in "abc")
    flops = sum(2 * len(ch.terms) for ch in chains) * shape.numel()
    rows["fma"] = _timed_row(
        f"fma chains, the largest path launch ({len(chains)} chains over "
        f"{tuple(shape)}; {len(calls['fma'])} launch shapes held to the "
        f"plain chains, 0 mismatches)",
        lambda: pairsum.fma_chains(chains, shape),
        lambda: [ch.plain(shape) for ch in chains],
        lambda: torch.addcmul(c, a, b),
        (sum(min(t.numel(), shape.numel()) for t in ops.values()) + n) * 4,
        flops, "fma", phase="slice", max_abs_err=e_fma,
        entries=n)

    rows.update(_tail_rows(calls["icp_tail"]))
    rows["icp_head"] = _head_row(calls["icp_head"],
                                 rows["icp_tail"]["launch_floor_ms"])

    e_s = 0.0
    for args in calls["score_terms"].values():
        got, want = score.per_point(*args), score.per_point_ref(*args)
        if not lu6.same_bits(got, want):
            raise SystemExit(f"[slice] FAIL score terms path launch "
                             f"{tuple(args[0].shape)}: differs from "
                             f"per_point_ref")
        e_s = max(e_s, _finite_err(got, want))
    args = max(calls["score_terms"].values(), key=lambda t: t[0].numel())
    m = args[0].numel()
    n_found = int((args[2] & args[3]).sum())
    a = torch.rand(args[0].shape, device=args[0].device)
    rows["score_terms"] = _timed_row(
        f"score terms, the largest path launch ({tuple(args[0].shape)}, "
        f"{n_found} found; {len(calls['score_terms'])} launch shapes held "
        f"to per_point_ref, 0 mismatches)", lambda: score.per_point(*args),
        lambda: score.per_point_ref(*args),
        lambda: torch.addcmul(a, args[0], args[1]), m * 14, n_found * 60,
        "score_terms", phase="slice", max_abs_err=e_s, entries=m)
    print(json.dumps({"path_launch": rows}), flush=True)
    return rows


# one ICP tail's work per pair. Bytes: round 4's 43 totals, the weight
# total, the int64 count, c1, T, err and the active flag read; T, err and
# the flag written. FP32 operations: the trace and damping (5 + 2 + 72),
# the solve (LU6_FLOPS), the error (2), the two 3x3 products and R c1 (2 x
# 45 + 15), the translation (6), upd @ T (112), the test (3); FP64: XLA's
# cos and sin of three angles (6 polynomials of ~10 operations and their
# reductions, ~20 operations each)
TAIL_BYTES = 43 * 4 + 4 + 8 + 12 + 64 + 4 + 1 + 64 + 4 + 1
# each 6x6 system's FP32 operations: the factorisation's dots and
# scalings, then the two triangular solves
LU6_FLOPS = sum(2 * i for j in range(6) for i in range(1, j)) + sum(
    2 * j * (6 - j) + (6 - j) for j in range(6)) + 2 * 36
TAIL_FLOPS = 79 + LU6_FLOPS + 2 + 105 + 6 + 112 + 3
TAIL_F64_FLOPS = 6 * 20


def _tail_rows(calls) -> dict:
    """Phase 5's ICP tail launches (the first of every pair count, before
    and after the convergence test starts), each held to
    ``icp._icp_tail_ref`` bit for bit, the largest measured against the
    plain version, the launch floor (an empty kernel's queued_ms in this
    call) and the bound; then the standalone solve and XLA math kernels,
    whose device functions the tail runs, on the same launches' systems
    and angles (formed by the plain version's steps), each held to its
    plain version and measured at the largest. Returns {name: row}."""
    from rescan_tpu_torch.ops import icp, lu6, pairsum, xla_math
    err = 0.0
    systems = []
    for args in calls.values():
        got, want = icp._icp_tail(*args), icp._icp_tail_ref(*args)
        if not icp.same_tail(got, want):
            raise SystemExit(f"[slice] FAIL icp tail path launch "
                             f"{tuple(args[0].shape)} it={args[-1]}: "
                             f"differs from _icp_tail_ref")
        err = max(err, _finite_err(got[0], want[0]),
                  _finite_err(got[1], want[1]))
        systems.append(icp._damped_system(args[0]))
    args = max(calls.values(), key=lambda a: a[0].shape[0])
    m = args[0].shape[0]
    dev = args[0].device
    floor, _ = queued_ms(lambda: pairsum.run("empty", dev))
    cm, rhs = icp._damped_system(args[0])
    solve_lib, _ = queued_ms(lambda: torch.linalg.solve_ex(cm, rhs)[0])
    say("slice", f"launch floor (an empty kernel, one block): {floor:.4f} "
        f"ms; torch.linalg.solve_ex of the largest tail launch's {m} "
        f"systems (the solve alone) {solve_lib:.4f} ms")
    rows = {"icp_tail": _timed_row(
        f"icp tail, the largest path launch ({m} pairs; {len(calls)} "
        f"launch shapes held to _icp_tail_ref, 0 mismatches)",
        lambda: icp._icp_tail(*args), lambda: icp._icp_tail_ref(*args),
        None, m * TAIL_BYTES,
        m * (TAIL_FLOPS + TAIL_F64_FLOPS * FP32_FLOP_PER_S / FP64_FLOP_PER_S),
        "icp_tail", phase="slice", max_abs_err=err, pairs=m,
        launch_floor_ms=floor, solve_library_ms=solve_lib)}

    e_lu = 0.0
    angles = []
    for c, b in systems:
        got, want = lu6.solve(c, b), lu6.solve_ref(c, b)
        if not lu6.same_bits(got, want):
            raise SystemExit(f"[slice] FAIL lu6 on the tail's systems "
                             f"{tuple(c.shape)}: differs from solve_ref")
        e_lu = max(e_lu, _finite_err(got, want))
        angles.append(torch.where(torch.isfinite(want), want, 0.0)[:, :3])
    rows["lu6"] = _timed_row(
        f"lu6 standalone, the largest tail launch's systems ({m}; "
        f"{len(systems)} launches' systems held to ops/lu6.py solve_ref, 0 "
        f"mismatches)", lambda: lu6.solve(cm, rhs),
        lambda: lu6.solve_ref(cm, rhs),
        lambda: torch.linalg.solve_ex(cm, rhs)[0],
        m * 48 * 4, m * LU6_FLOPS, "lu6", phase="slice",
        max_abs_err=e_lu, systems=m, launch_floor_ms=floor)

    def plain_sincos(v):
        return torch.stack([xla_math.cos_ref(v), xla_math.sin_ref(v)])
    e_m = 0.0
    for x in angles:
        got, want = xla_math.sincos(x), plain_sincos(x)
        if not lu6.same_bits(got, want):
            raise SystemExit(f"[slice] FAIL xla_math sincos on the tail's "
                             f"angles {tuple(x.shape)}: differs from the "
                             f"plain version")
        e_m = max(e_m, _finite_err(got, want))
    x = max(angles, key=lambda a: a.numel())
    rows["xla_math"] = _timed_row(
        f"xla_math sincos standalone, the largest tail launch's angles "
        f"({tuple(x.shape)}; {len(angles)} launches' angles held to the "
        f"plain versions, 0 mismatches)", lambda: xla_math.sincos(x),
        lambda: plain_sincos(x), None, x.numel() * 12,
        x.numel() * 40 * FP32_FLOP_PER_S / FP64_FLOP_PER_S, "xla_math",
        phase="slice", max_abs_err=e_m, entries=x.numel(),
        launch_floor_ms=floor)
    return rows


# FP32 operations per point of each ICP head form (ops/icp.py
# ``_icp_head``): A the weight (a division, a subtraction, a product); B
# the deviation and its square; C sigmas * std and two compares; D p, p2 -
# c2 and d (9 subtractions), the cross product (3 products and 3 FMAs), ddn
# (3 products, 2 additions), w j6 (6 products) and ddn^2
HEAD_FLOPS = (3, 2, 3, 9 + 9 + 5 + 6 + 1)


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` by the host clock over ``reps`` runs
    after one warm-up (a plain version that runs on the CPU)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _head_bytes(form: int, args, outs) -> int:
    """The bytes one ICP head form must move: each operand read once (form
    A's scene arrays: the rows its indices reach), each output written
    once."""
    from rescan_tpu_torch.ops import icp
    ops = [a for a in args if torch.is_tensor(a)]
    if form == icp.HEAD_A:
        rows = int(torch.unique(args[0].clamp_min(0)).numel())
        ops = ops[:4] + [ops[4][:rows], ops[5][:rows]]
    return sum(v.numel() * v.element_size() for v in ops + list(outs))


def head_bound(form: int, args, outs) -> tuple:
    """(bound ms, what sets it, bytes) of one ICP head form's launch: the
    larger of its bytes (``_head_bytes``) over the memory rate and its
    FP32 operations (``HEAD_FLOPS``) over the FP32 rate."""
    b, n = args[0].shape[:2]
    n_bytes = _head_bytes(form, args, outs)
    bound, by = max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (HEAD_FLOPS[form] * b * n / FP32_FLOP_PER_S * 1e3,
                     "operations"))
    return bound, by, n_bytes


def _head_row(calls, floor: float) -> dict:
    """Phase 5's ICP head launches (the first of every form and shape),
    each held bit for bit (a NaN equal to any NaN) to
    ``icp._icp_head_ref`` on CPU copies of its operands, since the plain
    version takes no CUDA tensor; then at the largest launch of each form
    its queued time, the plain version's on the host, the bound and the
    launch floor. Returns the kernels line's row: one iteration's four
    forms summed, each form beside it."""
    from rescan_tpu_torch.ops import icp, lu6
    err = 0.0
    for form, *args in calls.values():
        got = icp._icp_head(form, *args)
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        for g, w in zip(got, icp._icp_head_ref(form, *cpu)):
            g = g.cpu()
            if not (lu6.same_bits(g, w) if g.is_floating_point()
                    else torch.equal(g, w)):
                raise SystemExit(f"[slice] FAIL icp head path launch, form "
                                 f"{form} {tuple(args[0].shape)}: differs "
                                 f"from _icp_head_ref")
            if g.is_floating_point():
                err = max(err, _finite_err(g, w))
    forms = {}
    for form in icp.HEAD_FORMS:
        mine = [c for c in calls.values() if c[0] == form]
        if not mine:
            raise SystemExit(f"[slice] FAIL: no icp head launch of form "
                             f"{form} recorded")
        args = max(mine, key=lambda c: c[1].shape[0] * c[1].shape[1])[1:]
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        b, n = args[0].shape[:2]
        bound, by, n_bytes = head_bound(form, args,
                                        icp._icp_head(form, *args))
        ms = kernel_ms(lambda f=form, a=args: icp._icp_head(f, *a),
                       "icp_head")
        forms["ABCD"[form]] = {
            "pairs": b, "points": n, "ms": ms, "timing": TIMING,
            "plain_ms": host_ms(lambda f=form, a=cpu: icp._icp_head_ref(
                f, *a), 3), "bytes": n_bytes, "bound_ms": bound,
            "bound_by": by, "share_of_bound": bound / ms,
            **icp.head_info(form, args[0].device)}
    row = {"ms": sum(f["ms"] for f in forms.values()), "timing": TIMING,
           "plain_ms": sum(f["plain_ms"] for f in forms.values()),
           "plain_on": "cpu (host clock): the plain version takes no CUDA "
                       "tensor", "library_ms": None,
           "bound_ms": sum(f["bound_ms"] for f in forms.values()),
           "bound_by": "bytes" if all(f["bound_by"] == "bytes"
                                      for f in forms.values())
           else "operations", "launch_floor_ms": floor,
           "max_abs_err": err, "launch_shapes_held": len(calls),
           "forms": forms}
    say("slice", f"icp head: {len(calls)} launch shapes (form x shape) of "
        f"the run held to _icp_head_ref on the CPU, 0 mismatches; at the "
        f"largest launch ({forms['A']['pairs']} pairs x "
        f"{forms['A']['points']} points) " + "; ".join(
            f"form {k} {f['ms']:.5f} ms (bound {f['bound_ms']:.5f} ms, "
            f"{f['bound_by']}, {f['bytes']} B, share {f['share_of_bound']:.3f}"
            f"; {f['shared_bytes']} B shared a CTA, {f['ctas_per_sm']} CTAs "
            f"per SM; plain on the CPU {f['plain_ms']:.3f} ms)"
            for k, f in forms.items())
        + f"; the four {row['ms']:.5f} ms against a bound of "
        f"{row['bound_ms']:.5f} ms and four launch floors of "
        f"{4 * floor:.5f} ms")
    print(json.dumps({"bench_launch": {"icp head, the largest path launch":
                                       row}}), flush=True)
    return row


@contextlib.contextmanager
def _aug_icp_sizes():
    """Record every one-pair ICP of the database augmentation
    (segment_transfer's icp_align_batched): its level-0 point count (a
    device tensor, read afterwards) and its padded length. Yields a
    function that returns [(points, padded)]."""
    from rescan_tpu_torch.ops import icp
    got = []
    real = icp.icp_align_batched

    def spy(obj_pts, obj_nrm, obj_mask, *a, **k):
        got.append((obj_mask.sum(), obj_pts.shape[1]))
        return real(obj_pts, obj_nrm, obj_mask, *a, **k)

    icp.icp_align_batched = spy
    try:
        yield lambda: [(int(n), p) for n, p in got]
    finally:
        icp.icp_align_batched = real


def _say_aug(phase: str, what: str, sizes) -> dict:
    small = sum(p <= 256 for _, p in sizes)
    say(phase, f"{what}: {len(sizes)} augmentation ICP placements, {small} "
        f"of them padded to 256 points or fewer (the one-pair FOLDED sums); "
        f"(level-0 points, padded): {sizes}")
    return {"placements": len(sizes), "at_most_256": small}


def _exact(ref, got) -> list:
    """The outputs of one rescan that differ from a reference's at all."""
    return [k for k in ("prop_counts", "prop_poses", "prop_scores",
                        "arr_poses", "class_ids", "instance_ids")
            if ref[k].shape != got[k].shape
            or not np.array_equal(ref[k], got[k])]


def phase_slice(cuda, root: str, class_file: str):
    from rescan_tpu_torch import sequences
    from rescan_tpu_torch.ops import search
    profiles = []
    # the label transfer's K2 calls (ops/labels.py: |dot| gate, the only
    # caller with use_abs_dot) are recorded and passed on unchanged
    label_calls = []
    real = search.nearest_gated

    def record(index, q_pos, q_nrm, radius, cos_gate, use_abs_dot=False):
        if use_abs_dot:
            label_calls.append((index, q_pos, q_nrm, radius, cos_gate,
                                use_abs_dot))
        return real(index, q_pos, q_nrm, radius, cos_gate,
                    use_abs_dot=use_abs_dot)

    search.nearest_gated = record
    path_calls, undo = _record_path_calls()
    t0 = time.perf_counter()
    try:
        with _aug_icp_sizes() as aug, _smoothing_parts() as smooth:
            _, launches, plain = _counted(
                "slice", "bench sequence",
                lambda: _run_driver(root, class_file, [cuda],
                                    profiles=profiles))
    finally:
        search.nearest_gated = real
        undo()
    wall = time.perf_counter() - t0
    out = sequences.read_outputs(root)
    counts = out["prop_counts"]
    from rescan_tpu_torch.core import database
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
        f"{launches}, plain calls {plain} (native level passes of seg2rsdb"
        f"'s bootstrap, which takes no device: "
        f"{HOST_STAGE_LEVELS['poisson_levels']}); proposals per object "
        f"{counts.tolist()}; {len(out['class_ids'])} level-1 points "
        f"labelled; the fma family (fma chains, XLA math, score terms) "
        f"{launches['fma'] + launches['xla_math'] + launches['score_terms']}"
        f" launches; ICP heads {launches['icp_head']} (four forms an "
        f"iteration), ICP tails {launches['icp_tail']} (standalone lu6 "
        f"{launches['lu6']}, XLA math {launches['xla_math']})")
    _say_aug("slice", "bench rescan", aug())
    # held to the JAX package's run on the slab at every limit, and to its
    # run on the CPU's HashGrid with the lower-ranked proposals at the
    # other-engine limits (rescan_tpu_torch/sequences.py)
    for path, other in ((BENCH_SLAB_NPZ, False), (BENCH_NPZ, True)):
        ref = dict(np.load(path))
        bad = sequences.compare_outputs(ref, out, other_engine=other)
        diffs = sequences.output_diffs(ref, out)
        if bad:
            raise SystemExit(f"[slice] FAIL vs {os.path.relpath(path, HERE)}"
                             f": {bad}; {diffs}")
        say("slice", f"bench rescan vs the JAX package's run "
            f"({os.path.relpath(path, HERE)}): proposal counts "
            f"{ref['prop_counts'].tolist()} identical, within the "
            + ("other-engine limits" if other else "limits")
            + f"; {diffs}" + ("" if other else
                              f"; outputs not bit-identical: "
                              f"{_exact(ref, out) or 'none'}"))
    p = profiles[0]
    stages = dict(p["pose_proposal"], **p["segment_transfer"])
    say("slice", "ICP substages, seconds (this run | with tree-ordered "
        "sums, context): " + ", ".join(
            f"{k} {stages[k]:.4f} | {TREE_SUM_ICP_SECONDS[k]}"
            for k in TREE_SUM_ICP_SECONDS))
    print(json.dumps({"timings": {
        "pose_proposal": {k: round(v, 4) for k, v in
                          p["pose_proposal"].items()},
        "segment_transfer": {k: round(v, 4) for k, v in
                             p["segment_transfer"].items()}}}), flush=True)
    engine_rows = _label_launches(label_calls)
    rows = _path_launches(path_calls)
    rows["grid_radius_knn"] = _smoothing_rows(smooth, stages["label_smooth"])
    rows["label_engines"] = engine_rows
    return launches, out, rows


@contextlib.contextmanager
def _smoothing_parts():
    """Time label_smooth's parts in the rescan (ops/labels.py): the radius
    search (the grid's host build, then ``radius_knn``, synchronised),
    ``native.smooth_graph`` and ``native.abswap``; record the search's
    launch (its queries copied) and smooth_graph's normals. Yields the
    record: {part: [seconds per call]}, "knn": [(grid, q, radius, k)],
    "nrm": [normals]."""
    from rescan_tpu_torch.core import native
    from rescan_tpu_torch.ops import hashgrid
    got = {"build_grid": [], "radius_knn": [], "smooth_graph": [],
           "abswap": [], "knn": [], "nrm": []}
    real = (hashgrid.build_grid, hashgrid.radius_knn, native.smooth_graph,
            native.abswap)

    def timed(part, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            got[part].append(time.perf_counter() - t0)
            return out
        return run

    def knn(grid, q, radius, k, chunk=4096):
        got["knn"].append((grid, q.clone(), radius, k))
        return timed("radius_knn", real[1])(grid, q, radius, k, chunk)

    def smooth_graph(idx, d2, nrm, *a):
        got["nrm"].append(nrm)
        return timed("smooth_graph", real[2])(idx, d2, nrm, *a)

    hashgrid.build_grid = timed("build_grid", real[0])
    hashgrid.radius_knn = knn
    native.smooth_graph = smooth_graph
    native.abswap = timed("abswap", real[3])
    try:
        yield got
    finally:
        (hashgrid.build_grid, hashgrid.radius_knn, native.smooth_graph,
         native.abswap) = real


def _smoothing_rows(smooth, label_smooth_s: float) -> dict:
    """label_smooth's split in the rescan; its radius search's launch held
    to the plain version bit for bit and timed (kernel, plain, the
    native HostGrid's host search of the same points, in this call), its
    pair counts and bound; the graph from the HostGrid's search against
    the kernel's (the same edges, the weights within rtol 1e-6). Returns
    the kernels-line row of grid_radius_knn."""
    from rescan_tpu_torch import config
    from rescan_tpu_torch.core import native
    from rescan_tpu_torch.ops import hashgrid
    if len(smooth["knn"]) != 1 or len(smooth["abswap"]) != 1:
        raise SystemExit(f"[slice] FAIL: {len(smooth['knn'])} smoothing "
                         f"searches, {len(smooth['abswap'])} alpha-beta "
                         f"swaps recorded (one each expected)")
    parts = {k: smooth[k][0] for k in ("build_grid", "radius_knn",
                                       "smooth_graph", "abswap")}
    parts["rest"] = label_smooth_s - sum(parts.values())
    grid, q, radius, k = smooth["knn"][0]
    st = {}
    want, t_p = _events_ms(lambda: hashgrid.radius_knn_ref(
        grid, q, radius, k, stats=st))
    got = hashgrid.radius_knn(grid, q, radius, k)
    _, e = _compare("grid radius_knn smoothing launch", got, want)
    t_k = [kernel_ms(lambda: hashgrid.radius_knn(grid, q, radius, k),
                     "grid_radius_knn", 10) for _ in range(2)]
    m, n = q.shape[0], grid.points.shape[0]
    # bytes: each query's position read, its k indices and distances and
    # its count written; each point's position and original index read
    n_bytes = m * (12 + k * 8 + 4) + n * 16
    bound, by = max((n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (st["in_radius"] * FLOP_PER_KNN_PAIR / FP32_FLOP_PER_S
                     * 1e3, "operations"))
    ms = min(t_k)
    # the native HostGrid's search of the same points, on the host
    pts = q.cpu().numpy()
    t0 = time.perf_counter()
    hidx, hd2, _ = native.HostGrid(pts, radius).radius_search(pts, radius, k)
    t_host = time.perf_counter() - t0
    r2 = np.float32(radius * radius)
    exps = (config.SMOOTH_DIST_EXP, config.SMOOTH_ANGLE_EXP)
    eh, wh = native.smooth_graph(hidx, hd2, smooth["nrm"][0], r2, *exps)
    eg, wg = native.smooth_graph(got[0].cpu().numpy(), got[1].cpu().numpy(),
                                 smooth["nrm"][0], r2, *exps)
    oh, og = np.lexsort(eh.T[::-1]), np.lexsort(eg.T[::-1])
    same = eh.shape == eg.shape and np.array_equal(eh[oh], eg[og])
    if not same or not np.allclose(wh[oh], wg[og], rtol=1e-6, atol=0):
        raise SystemExit(f"[slice] FAIL: the HostGrid's graph has "
                         f"{len(eh)} edges, the kernel's {len(eg)}; same "
                         f"edges: {same}")
    nz = wg[og] != 0
    w_rel = float(np.max(np.abs(wh[oh] - wg[og])[nz] / np.abs(wg[og][nz]),
                         initial=0))
    say("slice", f"label_smooth {label_smooth_s:.4f} s: radius search "
        f"{parts['build_grid'] + parts['radius_knn']:.4f} s (grid build "
        f"{parts['build_grid']:.4f}, radius_knn {parts['radius_knn']:.4f} "
        f"synchronised), smooth_graph "
        f"{parts['smooth_graph']:.4f}, alpha-beta swap {parts['abswap']:.4f},"
        f" the rest {parts['rest']:.4f}")
    say("slice", f"the smoothing search's launch: {m} queries, K {k}, r "
        f"{radius}, cap {grid.cap}; 0 mismatches against the plain "
        f"version; kernel {ms:.4f} ms (runs {[round(t, 4) for t in t_k]}),"
        f" plain {t_p:.3f} ms, the native HostGrid's host search "
        f"{t_host * 1e3:.3f} ms; pairs evaluated {st['pairs']}, within r "
        f"{st['in_radius']}; bound {bound:.5f} ms ({by}), kernel at "
        f"{bound / ms:.5f} of it; the HostGrid's graph: the same "
        f"{len(eg)} edges, weights within {w_rel:.3g} relative")
    row = {"queries": m, "points": n, "k": k, "cap": grid.cap, "ms": ms,
           "ms_runs": t_k, "timing": TIMING, "plain_ms": t_p,
           "plain_timing": "CUDA events around one call",
           "hostgrid_ms": t_host * 1e3, "bound_ms": bound, "bound_by": by,
           "share_of_bound": bound / ms, "max_abs_err": e,
           "pairs": st["pairs"], "in_radius": st["in_radius"],
           "label_smooth_split_s": parts}
    print(json.dumps({"smoothing": row}), flush=True)
    return row


def _label_launches(calls) -> dict:
    """Phase 5's label-transfer launches (one per placement: the scan
    points in the placement's bbox, in the object's frame), each held to
    the plain version bit for bit and measured as phase 3's bench
    launches are, after the run."""
    if not calls:
        raise SystemExit("[slice] FAIL: no label-transfer launch recorded")
    rows = [_bench_row(f"K2 label transfer {k + 1}/{len(calls)}",
                       "nearest_gated", *c, phase="slice")
            for k, c in enumerate(calls)]
    big = max(range(len(rows)), key=lambda k: rows[k]["queries"])
    say("slice", f"label transfer: {len(rows)} launches, queries "
        f"{[r['queries'] for r in rows]}, kernel ms total "
        f"{sum(r['ms'] for r in rows):.4f}; the largest is launch "
        f"{big + 1}")
    # the grid and dense engines on the largest launch, built on the
    # object's points (the slab's, in original order) with the JAX
    # package's cell, 1.5x the transfer radius (labels.py:95)
    from rescan_tpu_torch import config
    from rescan_tpu_torch.ops import search
    slab = calls[big][0]
    pts, nrm = (t[:slab.n_valid].cpu().numpy()
                for t in search.index_arrays(slab))
    cell = config.LABEL_TRANSFER_STATIC_RADIUS_SCALE \
        * config.LABEL_TRANSFER_RADIUS
    return _engine_bench(f"K2 label transfer {big + 1}/{len(rows)}",
                         ("nearest_gated",) + tuple(calls[big]),
                         (pts, nrm, cell), rows[big]["ms"], phase="slice")


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
    from rescan_tpu_torch import config
    from rescan_tpu_torch.core.pointcloud import PointCloud
    from rescan_tpu_torch.utils import synthetic
    from rescan_tpu_torch.ops import gnn, icp, search
    from rescan_tpu_torch.parallel import mesh as pmesh
    from rescan_tpu_torch.sequences import SEQ_NAME

    gt = os.path.join(bench_root, SEQ_NAME, "gt_segmentation")
    scene = PointCloud.from_ply(os.path.join(gt, "scan_001.ply"))
    base = PointCloud.from_ply(os.path.join(gt, "scan_000.ply"))
    lead = slots[0]
    slab = search.build_index(scene.pos(2), config.SCENE_REFINE_ICP_MAX_DIST,
                              normals=scene.nrm(2), tile=1024, device=lead)
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
    _reset_counts()
    t0 = time.perf_counter()
    T_sh, _ = pmesh.icp_refine_indexed_dpsp(m, slab, upts, unrm, umask, own,
                                            val, T0, *args)
    t_sh = time.perf_counter() - t0
    launches, plain = _counts()
    if (launches["nearest_gated"] == 0 or launches["pairsum"] == 0
            or launches["icp_head"] == 0 or launches["icp_tail"] == 0
            or any(plain.values())):
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
    if not np.array_equal(T_sh, T1):
        raise SystemExit(f"[mesh] FAIL (c): the dp x sp poses differ from "
                         f"the single loop's by {np.abs(T_sh - T1).max()}")
    if max(res) >= 1e-3 or not max(moved) > 0:
        raise SystemExit(f"[mesh] FAIL (c): residuals {res}, moved {moved}")
    say("mesh", f"(c) dp x sp ICP, 2 pairs ({upts.shape[1]} points each) "
        f"on the {slab.n_valid}-point level-2 slab, {m.shape}: bit-identical "
        f"to the single loop (mean residual {max(res):.3g}), {n_iter} "
        f"iterations; "
        f"{t_sh:.3f}s vs single {t_1:.3f}s (host clock); kernel launches "
        f"{launches}, plain calls {plain}")


def _mesh_smoothing(bench_root: str, lead) -> None:
    """(d): the torch engine against the native one on the rescan's
    level-1 graph, from its predicted labels with 10 % of them set to a
    random other label (seeded), both timed."""
    from rescan_tpu_torch.core import database
    from rescan_tpu_torch.core.pointcloud import PointCloud
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
    labels.build_smoothing_graph(cloud, lead)
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
        f"(host), each including the {t_graph:.3f}s graph build (its "
        f"radius search on the card); "
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


def _run_eval_driver(root: str, class_file: str, devices, profiles=None):
    from rescan_tpu_torch.pipeline import driver
    from rescan_tpu_torch.sequences import EVAL_DIR, SEQ_NAME
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(io.StringIO()), _host_stages():
            driver.run_sequence(SEQ_NAME, class_file, profiles=profiles,
                                devices=devices,
                                eval_folder=os.path.join(root, EVAL_DIR))
    finally:
        os.chdir(cwd)


def _synced(fn):
    """(fn(), host seconds) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _cpu_calls(phase: str, what: str) -> None:
    import rescan_tpu_torch
    if sum(rescan_tpu_torch.CPU_CALLS.values()):
        raise SystemExit(f"[{phase}] FAIL {what}: device work on CPU "
                         f"tensors {dict(rescan_tpu_torch.CPU_CALLS)}")


def _eval_small(cuda, work: str) -> None:
    """(a): the small 3-scan sequence, both rescans held to the JAX
    package's committed run on the sorted slab, the first also to its run
    on the CPU's HashGrid, and the metrics to the committed metrics, all
    at sequences.compare_outputs's one set of tolerances."""
    from rescan_tpu_torch import sequences
    root = os.path.join(work, "small3")
    class_file = sequences.write_eval_sequence(root, small=True)
    with _aug_icp_sizes() as aug:
        _, launches, plain = _counted(
            "eval", "(a) small 3-scan sequence",
            lambda: _run_eval_driver(root, class_file, [cuda]))
    ref = dict(np.load(REF3_NPZ))
    slab = dict(np.load(REF3_SLAB_NPZ))
    got = sequences.sequence_outputs(root)
    msgs = []
    for k, sub in enumerate(sequences.rescans(root)):
        g = sequences.split_outputs(got, sub)
        for name, src in (("slab", slab), ("HashGrid", ref)):
            r = sequences.split_outputs(src, sub)
            diffs = sequences.output_diffs(r, g)
            msgs.append(f"{sub} vs the {name} run: {diffs}")
            # the JAX package's engines part on rescan 2 (sequences.py)
            bad = sequences.compare_outputs(
                r, g, other_engine=name == "HashGrid" and k > 0)
            # the card computes the JAX package's slab run bit for bit
            if name == "slab":
                bad = bad + [f"not bit-identical: {k}" for k in _exact(r, g)]
            if bad:
                raise SystemExit(f"[eval] FAIL (a) {sub} vs the JAX "
                                 f"package's {name} run: {bad}; {diffs}")
    metrics = sequences.evaluate_sequence(root, device=cuda)
    want = {k: float(ref[f"metric/{k}"]) for k in sequences.METRICS}
    bad = sequences.compare_metrics(want, metrics)
    if bad:
        raise SystemExit(f"[eval] FAIL (a) metrics: {bad}")
    say("eval", "(a) small 3-scan sequence vs the JAX package's committed "
        "outputs (both rescans bit-identical to the slab run): "
        + "; ".join(msgs) + f"; kernel launches {launches}, plain calls "
        f"{plain}")
    _say_aug("eval", "(a) small 3-scan sequence", aug())
    say("eval", "(a) metrics (card | JAX, CPU): " + ", ".join(
        f"{k} {metrics[k]!r} | {want[k]!r}" for k in sequences.METRICS))


def _eval_bench(cuda, work: str):
    """(b): the bench room as a 3-scan sequence on [cuda:0]; returns its
    root."""
    import rescan_tpu_torch
    from rescan_tpu_torch import sequences
    root = os.path.join(work, "bench3")
    t0 = time.perf_counter()
    class_file = sequences.write_eval_sequence(root, small=False)
    say("eval", f"(b) bench 3-scan sequence written in "
        f"{time.perf_counter() - t0:.1f}s")
    profiles = []
    rescan_tpu_torch.CPU_CALLS.clear()
    with _aug_icp_sizes() as aug:
        (_, launches, plain), wall = _synced(lambda: _counted(
            "eval", "(b) bench 3-scan sequence",
            lambda: _run_eval_driver(root, class_file, [cuda],
                                     profiles=profiles)))
    _say_aug("eval", "(b) bench 3-scan sequence", aug())
    per = []
    for p in profiles:
        secs = p["pose_proposal"]["total"] + p["segment_transfer"]["total"]
        per.append(secs)
        print(json.dumps({"eval_timings": {
            "timestep": p["timestep"], "seconds": secs,
            "pose_proposal": {k: round(v, 4) for k, v in
                              p["pose_proposal"].items()},
            "segment_transfer": {k: round(v, 4) for k, v in
                                 p["segment_transfer"].items()}}}),
            flush=True)
    out = {sub: sequences.read_outputs(root, sub)
           for sub in sequences.rescans(root)}
    for sub, o in out.items():
        if not len(o["class_ids"]) or not o["prop_counts"].any():
            raise SystemExit(f"[eval] FAIL (b) {sub}: no proposals or no "
                             f"labels")
    say("eval", f"(b) bench 3-scan sequence in {wall:.1f}s (driver, eval "
        f"files included): seconds per rescan "
        + ", ".join(f"{p['timestep']} {s:.4f} (pose_proposal "
                    f"{p['pose_proposal']['total']:.4f} + segment_transfer "
                    f"{p['segment_transfer']['total']:.4f})"
                    for p, s in zip(profiles, per))
        + f"; proposals per object "
        + ", ".join(f"{k} {o['prop_counts'].tolist()}" for k, o in out.items())
        + f"; kernel launches {launches}, plain calls {plain}")

    metrics, t_dev = _synced(lambda: sequences.evaluate_sequence(
        root, device=cuda))
    _cpu_calls("eval", "(b) evaluators on the card")
    cpu, t_cpu = _synced(lambda: sequences.evaluate_sequence(
        root, device="cpu"))
    rescan_tpu_torch.CPU_CALLS.clear()
    if json.dumps(metrics, sort_keys=True) != json.dumps(cpu,
                                                         sort_keys=True):
        raise SystemExit(f"[eval] FAIL (b) card evaluators {metrics} vs "
                         f"the CPU's {cpu}")
    ctx = os.path.join(HERE, "RESULTS_r02.json")
    tpu = {}
    if os.path.exists(ctx):
        with open(ctx) as f:
            tpu = json.load(f)
    say("eval", f"(b) evaluators on the card in {t_dev:.3f}s, equal to the "
        f"CPU's ({t_cpu:.3f}s; both host clock, eval files read "
        f"included): " + ", ".join(
            f"{k} {v!r}" for k, v in metrics.items()))
    say("eval", "(b) context only, not a gate: RESULTS_r02.json (JAX on a "
        "TPU, an older smoothing default): " + ", ".join(
            f"{k} {tpu[k]}" for k in (
                *sequences.METRICS, "instance_transfer_mIoU_per_scan",
                "instance_transfer_mIoU_with_chair_equivalence_per_scan")
            if k in tpu))
    print(json.dumps({"eval_metrics": metrics, "seconds_per_rescan": per,
                      "eval_seconds": {"cuda": t_dev, "cpu": t_cpu}}),
          flush=True)
    return root


def _read_png(path: str) -> np.ndarray:
    """An RGB8 PNG of filter-0 rows, as render.write_png writes it."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(
                body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if (rows[:, 0] != 0).any():
        raise SystemExit("[eval] FAIL (c) PNG rows not filter 0")
    return rows[:, 1:].reshape(h, w, 3)


VIEWS = {
    "instance": [],
    "class surfels EDL": ["--mode", "class", "--surfels", "--edl", "1.0"],
    "score proposals overlays": ["--mode", "score", "--placement_mode",
                                 "proposals", "--show_bboxes", "--show_grid",
                                 "--show_axes"],
    "distance-field slice": ["--df_slice_y", "0.3"],
}


def _eval_viewer(cuda, work: str, root: str) -> None:
    """(c): the viewer on the last database of (b), on the card against
    the CPU."""
    import rescan_tpu_torch
    from rescan_tpu_torch.viewer import cli, render
    from rescan_tpu_torch import sequences
    rsdb = os.path.join(sequences.SEQ_NAME, "scan_002.rsdb")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for name, argv in VIEWS.items():
            args = [rsdb, "--resolution", "1024", "768"] + argv
            out = os.path.join(work, name.replace(" ", "_") + ".png")
            rescan_tpu_torch.CPU_CALLS.clear()
            captured = []
            real = render.render_rsdb

            def keep(db, **kw):
                captured.append((db, kw))
                return real(db, **kw)

            render.render_rsdb = keep
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(args + ["--output", out, "--device", str(cuda)])
            finally:
                render.render_rsdb = real
            db, kw = captured[0]
            img = real(db, **kw)
            ms = cuda_ms(lambda: real(db, **kw), 3)
            _cpu_calls("eval", f"(c) {name}")
            kw_cpu = dict(kw, device="cpu")
            t0 = time.perf_counter()
            ref = real(db, **kw_cpu)
            t_cpu = time.perf_counter() - t0
            rescan_tpu_torch.CPU_CALLS.clear()
            a, b = img.cpu().numpy().astype(np.int64), ref.numpy()
            d = np.abs(a - b).max(axis=-1)
            off, lvl = int((d > 0).sum()), int(d.max())
            exact = name == "instance"
            if (exact and off) or lvl > 1 or off > 0.001 * d.size:
                raise SystemExit(f"[eval] FAIL (c) {name}: {off} pixels off "
                                 f"the CPU render, by up to {lvl} levels")
            png = _read_png(out)
            if not np.array_equal(png, img.cpu().numpy()):
                raise SystemExit(f"[eval] FAIL (c) {name}: the PNG read "
                                 f"back differs from the render")
            colours = len(np.unique(png.reshape(-1, 3), axis=0))
            say("eval", f"(c) {name} ({' '.join(argv) or '--mode instance'}"
                f"): {ms:.3f} ms per render on the card (CUDA events, mean "
                f"of 3), CPU {t_cpu * 1e3:.1f} ms (host clock); {off} pixels "
                f"off the CPU render (max {lvl} level); PNG "
                f"{os.path.getsize(out)} B read back equal, {colours} "
                f"colours")
    finally:
        os.chdir(cwd)


def phase_eval(cuda, work: str) -> None:
    _eval_small(cuda, work)
    root = _eval_bench(cuda, work)
    _eval_viewer(cuda, work, root)


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
        grid_run = phase_parity(cuda, work)
        launches, single, path_rows = phase_slice(cuda, bench_root,
                                                  bench_class)
        phase_mesh(work, bench_root, bench_class, single)
        phase_eval(cuda, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the main path's own launches where phase 5 measured them; pairsum's
    # heavy round at the bench ICP launch's shape from phase 3
    rows = dict(kern["rows"], **{k: path_rows[k] for k in PORT_KERNELS
                                 if k != "pairsum"})
    err = dict(kern["err"], **{k: path_rows[k]["max_abs_err"]
                               for k in PORT_KERNELS if k != "pairsum"})
    for k in ("fma", "score_terms"):
        err[k] = max(err[k], kern["rows"][k]["max_abs_err"])
    err["pairsum"] = max(err["pairsum"], path_rows["pairsum"]["max_abs_err"])
    rows["grid_radius_knn"] = path_rows["grid_radius_knn"]
    err["grid_radius_knn"] = max(err["grid_radius_knn"],
                                 rows["grid_radius_knn"]["max_abs_err"])
    for k, row in path_rows["label_engines"].items():
        err[k] = max(err[k], row["max_abs_err"])
    def entry(name):
        row = rows[name]
        out = {"name": name, "route": "cuda",
               "source": SOURCES.get(name, KERNEL_SOURCE),
               "replaces": REPLACES_OF.get(name, REPLACES),
               "launches": launches[name], "max_abs_err": err[name],
               "ms": row["ms"], "timing": row["timing"],
               "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
               "bound_by": row["bound_by"],
               # no PyTorch call gates a nearest neighbour by normal, nor
               # computes a sine and cosine at once, nor the ICP's tail;
               # the sums' is the Gram product of their columns
               "library_ms": row.get("library_ms")}
        if name in ("fma", "score_terms"):
            # torch.addcmul moves the same bytes but computes another
            # function: a byte-rate yardstick, not a library time
            out.update(library_ms=None,
                       addcmul_yardstick_ms=row["library_ms"])
        if "launch_floor_ms" in row:
            out["launch_floor_ms"] = row["launch_floor_ms"]
        if name == "icp_tail":
            out["solve_library_ms"] = row["solve_library_ms"]
        if name == "icp_head":
            # one iteration's four forms at the largest launch, summed;
            # the plain version on the CPU
            out.update(forms=row["forms"], plain_on=row["plain_on"])
        if name in INSIDE_TAIL:
            # on the path inside icp_tail_kernel: each of its launches
            # runs this kernel's device function; timed standalone
            out.update(launches=launches["icp_tail"], runs_inside="icp_tail",
                       standalone_launches=launches[name])
        if name in ("grid_nearest_gated", "dense_nearest"):
            # off the main path (its indexes are slabs): the numbers of
            # the scoring launch, every bench launch's beside them with
            # K1/K2's time on the same queries
            out["bench_launches"] = {
                what: {k: r[name][k] for k in (
                    "queries", "points", "cell", "ms", "plain_ms",
                    "k1_k2_ms", "bound_ms", "bound_by", "pairs",
                    "in_radius")}
                for what, r in dict(
                    kern["rows"]["engine_launches"],
                    **{"K2 label transfer, largest":
                       path_rows["label_engines"]}).items()}
        if name == "grid_nearest_gated":
            # its launches on the grid engine's small sequence (phase 4)
            out["grid_engine_launches"] = grid_run[name]
        if name == "grid_radius_knn":
            out.update(hostgrid_ms=row["hostgrid_ms"],
                       label_smooth_split_s=row["label_smooth_split_s"])
        if name == "poisson_levels":
            # a pyramid a call: phase 3's bench scan; launches: phase 5's
            # card pyramids
            out.update({k: row[k] for k in (
                "plain_timing", "points", "kept", "rounds", "voxels")})
        return out
    kernels = [entry(name) for name in ("gated_min", "nearest_gated")
               + PORT_KERNELS + ENGINE_KERNELS + ("poisson_levels",)]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
