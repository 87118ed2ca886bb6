"""Several devices in one process — the port of rescan_tpu/parallel/mesh.py.

The JAX package shards with ``shard_map`` over a ``jax.sharding.Mesh``:
one controller, SPMD programs, psums lowered onto the interconnect. The
port's driver is one process too, so its mesh is a single-process one:

* a mesh is an ordered list of shard slots, each a ``torch.device``
  (repeats allowed: several slots on one card, or on the CPU, play the
  role of the JAX package's virtual CPU devices) with its own CUDA
  stream, read as a (dp, sp) grid in row-major order;
* each slot reads its own replica of the read-only inputs (scene slab,
  object tables), made once per device;
* launches are issued to every slot before any result is read;
* gathers run on one device in fixed slot order, and a sum over points
  split across sp slots runs slot after slot, each continuing the
  previous slot's chains (ops/pairsum.py), so results do not depend on
  timing or on the number of slots.

No torch.distributed, no NCCL: the largest cross-shard payload is the
carried state of the ICP's 43 sums per pair, once per round.

The scaling axes are the JAX package's: dp over pose hypotheses and
(object, pose) pairs, sp over an object's points, whose per-pair sums
chain across the sp slots.
"""

from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import dense_nn, gnn, hashgrid, icp, pairsum, score, search


def active_device_count() -> int:
    """Devices the stages mesh over by default: every visible card, unless
    RESCAN_DEVICES=N caps the mesh to the first N."""
    return (int(os.environ.get("RESCAN_DEVICES", "0") or 0)
            or torch.cuda.device_count())


def visible_devices() -> List[torch.device]:
    """The first ``active_device_count()`` cards (at most the number
    visible). Raises without a card."""
    resolve_device("cuda")
    n = min(active_device_count(), torch.cuda.device_count())
    return [torch.device("cuda", i) for i in range(max(n, 1))]


def resolve_devices(device=None, devices=None) -> List[torch.device]:
    """The device list of a stage: ``devices`` when given (its first is
    the lead, and ``device``, if also given, must be it), else
    ``[device]`` when a device is named, else every visible card
    (``visible_devices``)."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("empty device list")
        if device is not None and resolve_device(device) != devs[0]:
            raise ValueError(f"device {device} is not the lead of {devs}")
        return devs
    if device is not None:
        return [resolve_device(device)]
    return visible_devices()


class Mesh:
    """An ordered list of shard slots read as a (dp, sp) grid, row-major:
    slot ``r * sp + j`` is dp row r, sp rank j."""

    def __init__(self, devices: Sequence, sp: int = 1):
        self.devices = [resolve_device(d) for d in devices]
        n = len(self.devices)
        if n == 0 or sp < 1 or n % sp:
            raise ValueError(f"{n} slots do not form a (dp, {sp}) mesh")
        self.sp = sp
        self.dp = n // sp
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        ids = [s.cuda_stream for s in self.streams if s is not None]
        if len(set(ids)) != len(ids):
            raise RuntimeError("two shard slots got the same CUDA stream")
        # id(obj) -> (obj, {device: replica}); obj is held so its id stays
        # unique while the mesh lives
        self._replicas = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    def flat(self) -> "Mesh":
        """The same slots, streams and replicas as one dp axis."""
        if self.sp == 1:
            return self
        m = Mesh.__new__(Mesh)
        m.__dict__.update(self.__dict__)
        m.sp, m.dp = 1, self.size
        return m

    @contextlib.contextmanager
    def slot(self, i: int):
        """Run the body on slot i: its device and stream, after the work
        already queued on that device's current stream (inputs made
        there)."""
        s = self.streams[i]
        if s is None:
            yield
            return
        dev = self.devices[i]
        with torch.cuda.device(dev):
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                yield

    def sync_slot(self, i: int) -> None:
        if self.streams[i] is not None:
            self.streams[i].synchronize()

    def _sync_all(self) -> None:
        for i in range(self.size):
            self.sync_slot(i)
        for d in dict.fromkeys(d for d in self.devices if d.type == "cuda"):
            torch.cuda.synchronize(d)

    def replicate(self, obj):
        """Per-slot replicas of a tensor, a tuple of tensors or an index
        (ops/search.py), copied once per device and kept while the mesh
        lives."""
        if isinstance(obj, tuple):
            parts = [self.replicate(x) for x in obj]
            return [tuple(p[i] for p in parts) for i in range(self.size)]
        entry = self._replicas.get(id(obj))
        if entry is None:
            entry = self._replicas[id(obj)] = (obj, {})
        reps = entry[1]
        copied = False
        for d in self.devices:
            if d not in reps:
                reps[d] = _to_device(obj, d)
                copied = True
        if copied:
            self._sync_all()
        return [reps[d] for d in self.devices]

    def gather(self, parts):
        """Per-slot results (tensors, or tuples of tensors) joined on the
        lead device in slot order, after every slot has finished."""
        self._sync_all()
        if isinstance(parts[0], tuple):
            out = tuple(torch.cat([p[k].to(self.lead) for p in parts])
                        for k in range(len(parts[0])))
        else:
            out = torch.cat([p.to(self.lead) for p in parts])
        # the parts live in the slots' stream pools: nothing may still
        # read them when they are freed
        self._sync_all()
        return out

    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(i)`` for every slot, each on its own thread inside
        ``slot(i)`` (a thread per slot lets each one wait on its own
        results, as each device's program does under shard_map). Returns
        the results in slot order; raises the first failure."""
        # CPU slots share the host's cores: each thread gets its share of
        # torch's intra-op threads, or the slots oversubscribe the host
        n_cpu = sum(d.type == "cpu" for d in self.devices)
        threads = torch.get_num_threads()

        def body(i):
            if self.devices[i].type == "cpu":
                torch.set_num_threads(max(1, threads // n_cpu))
            with self.slot(i):
                out = fn(i)
            self.sync_slot(i)
            return out

        try:
            with ThreadPoolExecutor(max_workers=self.size) as ex:
                futs = [ex.submit(body, i) for i in range(self.size)]
        finally:
            torch.set_num_threads(threads)
        errors = [f.exception() for f in futs]
        first = next((e for e in errors
                      if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return [f.result() for f in futs]


def _to_device(obj, dev: torch.device):
    if isinstance(obj, (gnn.SortedSlab, gnn.SlabSet, hashgrid.HashGrid,
                        dense_nn.DenseIndex)):
        return obj.to(dev)
    return torch.as_tensor(obj).to(dev)


class _CrossSum:
    """The sums of one dp row's sp slots over a pair's points, each slot
    holding one run of them: slot j continues the chains of slot j - 1
    (``ops.pairsum``'s carried state), so the row gets the single-device
    sums bit for bit, and the last slot's totals reach every slot from
    that one tensor, so all ranks take identical decisions from them.
    The slots take their turns in order at a shared barrier, which a
    failing rank aborts (``barrier.abort()``)."""

    def __init__(self, mesh: Mesh, slots: Sequence[int]):
        self.mesh = mesh
        self.slots = list(slots)
        self.barrier = threading.Barrier(len(self.slots))
        self.state = None
        self.totals = None

    def hook(self, rank: int) -> Callable:
        def sums(x, spec):
            return self._sums(rank, x, spec)
        return sums

    def _sums(self, rank: int, x: torch.Tensor, spec) -> torch.Tensor:
        m = self.mesh
        slot = self.slots[rank]
        dev = m.devices[slot]
        n, last = x.shape[1], len(self.slots) - 1
        for turn in range(len(self.slots)):
            if turn == rank:
                prev = None if rank == 0 else self.state.to(dev)
                st = pairsum.pairsum(x, spec, n0=rank * n,
                                     n_total=n * len(self.slots), state=prev)
                if rank == last:
                    self.totals = pairsum.totals(st, spec,
                                                 n * len(self.slots))
                self.state = st
                m.sync_slot(slot)
            self.barrier.wait()
        out = self.totals.to(dev, copy=True)
        m.sync_slot(slot)
        # every rank holds its copy before the next round's turns begin
        self.barrier.wait()
        return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, sp) mesh over the first n_devices of ``devices`` (default:
    the visible cards), dp = n_devices // sp."""
    base = list(devices) if devices is not None else visible_devices()
    n = n_devices or len(base)
    dp = n // sp
    return Mesh(base[:dp * sp], sp=sp)


def make_flat_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A one-axis mesh over the first n_devices of ``devices`` (default:
    the visible cards) — the stages' hypothesis/pair axis."""
    base = list(devices) if devices is not None else visible_devices()
    return Mesh(base[:n_devices or len(base)])


def refine_sp_factor(n_pairs: int, n_points: int,
                     n_devices: Optional[int] = None) -> int:
    """The sp (point-axis) factor for a refine-ICP launch: how many slots
    each pair's point run should span. >1 only when pairs alone cannot
    fill the mesh; each sp shard keeps >= 512 points so the kernel's
    query blocks stay full."""
    n_dev = n_devices or active_device_count()
    pow2_pairs = 1 << max(int(np.ceil(np.log2(max(n_pairs, 1)))), 0)
    sp = max(1, n_dev // pow2_pairs)
    while sp > 1 and (n_points % sp != 0 or n_points // sp < 512):
        sp //= 2
    return sp


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def score_multi_sharded(mesh: Mesh, index: gnn.SortedSlab, pts_all,
                        nrm_all, mask_all, hyps, owner, radius,
                        sigma) -> list:
    """ops.score._score_multi with the hypothesis axis split over every
    slot; the slab and the object tables are replicated. len(hyps) must
    be a multiple of the mesh size (ScoreStream sizes its slices so).
    Returns the per-slot scores, launched and unread: ``mesh.gather``
    joins them in hypothesis order."""
    n = mesh.size
    if len(hyps) % n:
        raise ValueError(f"{len(hyps)} hypotheses over {n} slots")
    hs = len(hyps) // n
    hyps = torch.as_tensor(hyps)
    owner = torch.as_tensor(owner)
    idx_r = mesh.replicate(index)
    tab_r = mesh.replicate((pts_all, nrm_all, mask_all))
    parts = []
    for i in range(n):
        dev = mesh.devices[i]
        with mesh.slot(i):
            parts.append(score._score_multi(
                idx_r[i], *tab_r[i], hyps[i * hs:(i + 1) * hs].to(dev),
                owner[i * hs:(i + 1) * hs].to(dev), radius, sigma))
    return parts


def score_hypotheses_sharded(mesh: Mesh, index: gnn.SortedSlab,
                             obj_pts: np.ndarray, obj_nrm: np.ndarray,
                             hyps: np.ndarray, radius: float,
                             sigma: float) -> np.ndarray:
    """Score H hypotheses of one object with hypotheses split over dp and
    the object's points over sp: each slot sums its points' scores per
    hypothesis, and the sp partial sums and point counts are added on the
    lead device in slot order. Returns (H,) scores."""
    dp, sp = mesh.dp, mesh.sp
    H, P = len(hyps), len(obj_pts)
    Hp = _round_up(max(H, 1), dp)
    Pp = _round_up(max(P, 1), sp)
    hyps_p = np.tile(np.eye(4, dtype=np.float32), (Hp, 1, 1))
    hyps_p[:H] = hyps
    pts_p = np.zeros((Pp, 3), np.float32)
    pts_p[:P] = obj_pts
    nrm_p = np.zeros((Pp, 3), np.float32)
    nrm_p[:P] = obj_nrm
    mask_p = np.zeros(Pp, bool)
    mask_p[:P] = True
    hs, ps = Hp // dp, Pp // sp

    idx_r = mesh.replicate(index)
    parts = []
    for i in range(mesh.size):
        r, j = divmod(i, sp)
        dev = mesh.devices[i]
        pt = slice(j * ps, (j + 1) * ps)
        with mesh.slot(i):
            h = torch.from_numpy(hyps_p[r * hs:(r + 1) * hs]).to(dev)
            per_pt, mask = score._score_terms(
                idx_r[i], torch.from_numpy(pts_p[None, pt]).to(dev),
                torch.from_numpy(nrm_p[None, pt]).to(dev),
                torch.from_numpy(mask_p[None, pt]).to(dev), h,
                torch.zeros(hs, dtype=torch.int64, device=dev), radius,
                sigma)
            parts.append((per_pt[..., None], mask[:1].sum(1)))
    mesh._sync_all()
    lead = mesh.lead
    out = []
    for r in range(dp):
        # the row's point runs continue one chain, slot after slot
        state = None
        for j in range(sp):
            x = parts[r * sp + j][0]
            with mesh.slot(r * sp + j):
                state = pairsum.pairsum(
                    x, score.SUM_SPEC, n0=j * ps, n_total=Pp,
                    state=None if state is None else state.to(x.device))
        s = pairsum.totals(state, score.SUM_SPEC, Pp)[:, 0].to(lead)
        cnt = sum(int(p[1]) for p in parts[r * sp:(r + 1) * sp])
        out.append(s / max(cnt, 1))
    res = torch.cat(out)[:H].cpu().numpy()
    mesh._sync_all()
    return res


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------

def _pad_pairs(obj_of_pair, pair_valid, T_init, Bp: int):
    B = len(T_init)
    T_p = np.tile(np.eye(4, dtype=np.float32), (Bp, 1, 1))
    T_p[:B] = _np(T_init, np.float32)
    own_p = np.zeros(Bp, np.int64)
    own_p[:B] = _np(obj_of_pair, np.int64)
    val_p = np.zeros(Bp, bool)
    val_p[:B] = _np(pair_valid, bool)
    return T_p, own_p, val_p


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def icp_refine_indexed_dpsp(mesh2d: Mesh, index: gnn.SortedSlab, uobj_pts,
                            uobj_nrm, uobj_mask, obj_of_pair, pair_valid,
                            T_init, max_dist: float, max_angle: float
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """ops.icp.icp_align_indexed on the (dp, sp) mesh: the pair axis
    split over dp and the per-object point axis over sp. Every per-pair
    sum of the ICP step runs over the row's sp slots in order, each slot
    continuing the previous one's chains (the ``sums`` hook of ops.icp,
    ``_CrossSum``), so all sp ranks of a row derive the same active set
    and stop at the same iteration, and the result is the single-device
    loop's bit for bit (tests/test_torch_mesh.py).
    With sp = 1 this is the flat split of ``icp_refine_indexed_sharded``.
    The sums take ops.icp's many-pair orders (``single=False``) whatever
    a slot's share: the stages mesh only their refinement batches, which
    the JAX package pads to 256 pairs. Returns (T, err) as numpy."""
    dp, sp = mesh2d.dp, mesh2d.sp
    B = len(T_init)
    Bp = _round_up(max(B, 1), dp)
    N = int(uobj_pts.shape[1])
    if N % sp:
        raise ValueError(f"{N} points per object over sp={sp}")
    T_p, own_p, val_p = _pad_pairs(obj_of_pair, pair_valid, T_init, Bp)
    bs, ns = Bp // dp, N // sp
    upts, unrm, umask = (torch.as_tensor(a) for a in
                         (uobj_pts, uobj_nrm, uobj_mask))
    idx_r = mesh2d.replicate(index)
    sums = [_CrossSum(mesh2d, range(r * sp, (r + 1) * sp)) if sp > 1
            else None for r in range(dp)]

    def work(i):
        r, j = divmod(i, sp)
        dev = mesh2d.devices[i]
        pt = slice(j * ns, (j + 1) * ns)
        pr = slice(r * bs, (r + 1) * bs)
        try:
            T, err, _, _ = icp.icp_align_indexed(
                upts[:, pt].to(dev), unrm[:, pt].to(dev),
                umask[:, pt].to(dev), torch.from_numpy(own_p[pr]).to(dev),
                torch.from_numpy(val_p[pr]).to(dev), idx_r[i],
                torch.from_numpy(T_p[pr]).to(dev), max_dist, max_angle,
                sums=sums[r].hook(j) if sums[r] is not None else None,
                single=False)
        except BaseException:
            # a rank that stops early must not leave its row waiting
            if sums[r] is not None:
                sums[r].barrier.abort()
            raise
        return T, err

    res = mesh2d.run(work)
    # every sp rank of a row holds the same result: take its first slot's
    T, err = mesh2d.gather([res[r * sp] for r in range(dp)])
    return T.cpu().numpy()[:B], err.cpu().numpy()[:B]


def icp_refine_indexed_sharded(mesh: Mesh, index: gnn.SortedSlab, uobj_pts,
                               uobj_nrm, uobj_mask, obj_of_pair, pair_valid,
                               T_init, max_dist: float, max_angle: float
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """ops.icp.icp_align_indexed with the pair axis split over every slot;
    the unique-object tables and the slab are replicated. Pairs are
    independent, so no cross-shard sum is needed; the sums' orders are
    ``icp_refine_indexed_dpsp``'s. Returns (T, err) as numpy."""
    return icp_refine_indexed_dpsp(mesh.flat(), index, uobj_pts, uobj_nrm,
                                   uobj_mask, obj_of_pair, pair_valid,
                                   T_init, max_dist, max_angle)


def icp_refine_sharded(mesh: Mesh, index: gnn.SortedSlab, pts_b, nrm_b,
                       mask_b, T_init, max_dist: float, max_angle: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """ops.icp.icp_align_batched with the (object, pose) batch split over
    every slot. Returns (T, err) as numpy."""
    B = len(T_init)
    return icp_refine_indexed_sharded(mesh, index, pts_b, nrm_b, mask_b,
                                      np.arange(B), np.ones(B, bool), T_init,
                                      max_dist, max_angle)


# ---------------------------------------------------------------------------
# Label transfer
# ---------------------------------------------------------------------------

def nearest_gated_sharded(mesh: Mesh, index: gnn.SortedSlab, q_pos, q_nrm,
                          radius: float, cos_gate: float,
                          use_abs_dot: bool = False) -> list:
    """search.nearest_gated with the query axis split over every slot —
    the label-transfer launch. The object slab is replicated; each
    query's gated 1-NN is independent, so nothing is summed. len(q_pos)
    must be a multiple of the mesh size. Returns the per-slot (idx, d2,
    dot), launched and unread: ``mesh.gather`` joins them in query
    order."""
    n = mesh.size
    if len(q_pos) % n:
        raise ValueError(f"{len(q_pos)} queries over {n} slots")
    qs = len(q_pos) // n
    q_pos = torch.as_tensor(q_pos)
    q_nrm = torch.as_tensor(q_nrm)
    idx_r = mesh.replicate(index)
    parts = []
    for i in range(n):
        dev = mesh.devices[i]
        with mesh.slot(i):
            parts.append(search.nearest_gated(
                idx_r[i], q_pos[i * qs:(i + 1) * qs].to(dev),
                q_nrm[i * qs:(i + 1) * qs].to(dev), radius, cos_gate,
                use_abs_dot=use_abs_dot))
    return parts

