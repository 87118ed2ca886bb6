"""ctypes bindings to the native host helper library (native/rescan_host.cpp).

The port builds the library itself at first use: g++ with the flags below
into ``rescan_tpu_torch/_build/librescan_host-<hash>.so``, the hash taken
over the source, the flags and the host CPU's feature flags (the build is
``-march=native``), as ``ops/gnn.py`` builds the CUDA kernel. A failed
build raises with g++'s stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "rescan_host.cpp")
_BUILD_DIR = os.path.join(_ROOT, "rescan_tpu_torch", "_build")
GXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
             "-shared", "-fPIC"]
_lib = None
_lib_lock = threading.Lock()


def _cpu_flags() -> bytes:
    """The host CPU's feature line, which ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path() -> str:
    """Where this source, flag set and CPU's library is (or will be)."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(GXX_FLAGS).encode()
                           + _cpu_flags()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"librescan_host-{tag}.so")


def _build(out: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"native: g++ failed ({r.returncode}):\n"
                           f"{r.stderr}")
    os.replace(tmp, out)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(library_path())
    return _lib


def _bind(path: str):
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    lib.rescan_poisson_subsample.restype = ctypes.c_int64
    lib.rescan_poisson_subsample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32)]
    lib.rescan_grid_build.restype = ctypes.c_void_p
    lib.rescan_grid_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float]
    lib.rescan_grid_free.argtypes = [ctypes.c_void_p]
    lib.rescan_grid_radius_search.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.rescan_resample_stream.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float)]
    lib.rescan_plane_counts.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32)]
    lib.rescan_plane_gather.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.POINTER(ctypes.c_uint8)]
    lib.rescan_abswap.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.rescan_union_find.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    # raw-address argtypes: these two sit on the SA per-iteration path,
    # where ctypes' POINTER cast machinery (~2 us/arg) would dominate the
    # native work; callers pass ndarray.ctypes.data ints
    lib.rescan_smooth_graph.restype = ctypes.c_int64
    lib.rescan_smooth_graph.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float)]
    lib.rescan_csr_from_edges.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float)]
    lib.rescan_pair_penalties.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_double, ctypes.c_void_p]
    lib.rescan_cov_update.restype = ctypes.c_int64
    lib.rescan_cov_update.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    lib.rescan_ransac_triplets.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64)]
    lib.rescan_overlap_counts.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_float, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
    lib.rescan_merge_shuffle.argtypes = [
        ctypes.c_int64, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32)]
    lib.rescan_meanfield_icm.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)]
    lib.rescan_alias_build.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    lib.rescan_sa_run.restype = ctypes.c_int64
    lib.rescan_sa_run.argtypes = (
        # n_iter, seed, restart_prob, init_temp, min_temp
        [ctypes.c_int32, ctypes.c_uint32, ctypes.c_double, ctypes.c_double,
         ctypes.c_double,
         # weights4*, wsum, n_past
         ctypes.c_void_p, ctypes.c_double, ctypes.c_int32,
         # swap_thr, replace_thr, dup/mismatch/existed/novel
         ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
         ctypes.c_double, ctypes.c_double,
         # decay_a, decay_b, base_scale, mah_scale
         ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
         # pdf_full, pdf_noswap, n_obj
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        # obj_static/uidx/class/sigma/pdf (5), prop_off/trans/score/
        # add_pdf/cent/sig (6), cells_off/cells (2)
        + [ctypes.c_void_p] * 13
        # n_extra, ex_trans/cent/sig/cells_off/cells
        + [ctypes.c_int64] + [ctypes.c_void_p] * 5
        # n_cells_total, n_scn_valid, n_past_arr
        + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
        # past_off/uidx/class/pos/objidx
        + [ctypes.c_void_p] * 5
        # n_init, init_uidx/arr_idx/objidx/ref/score
        + [ctypes.c_int32] + [ctypes.c_void_p] * 5
        # scene_idx, n_arr, follow, n_follow
        + [ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32]
        # trace, out_mut, out_n_mut, out_arr, out_scores, out_n, out_init_max
        + [ctypes.c_void_p] * 7)
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def poisson_subsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Greedy first-in-order Poisson-disk subsample; returns selected indices
    (exact reference semantics: lib/rs/rs_pointcloud.h:985-1106)."""
    lib = _load()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = len(pts)
    out = np.empty(n, dtype=np.int32)
    cnt = lib.rescan_poisson_subsample(_fptr(pts), n, ctypes.c_float(voxel),
                                       _iptr(out))
    return out[:cnt].copy()


def resample_stream(areas: np.ndarray, n_samples: int, face_seed: int,
                    bary_seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's mesh-resampling sample stream (bit-exact): returns
    (face_idx [n], barycentric [n,3])."""
    lib = _load()
    a = np.ascontiguousarray(areas, dtype=np.float64)
    face = np.empty(n_samples, dtype=np.int32)
    bary = np.empty((n_samples, 3), dtype=np.float32)
    lib.rescan_resample_stream(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(a), n_samples,
        face_seed, bary_seed, _iptr(face), _fptr(bary))
    return face, bary


def plane_counts(pts: np.ndarray, active: np.ndarray, normals: np.ndarray,
                 offs: np.ndarray, dist: float) -> np.ndarray:
    """Inlier counts of candidate planes over the active points
    (OpenMP over candidates)."""
    lib = _load()
    p = np.ascontiguousarray(pts, np.float32)
    a = np.ascontiguousarray(active, np.uint8)
    nr = np.ascontiguousarray(normals, np.float32)
    of = np.ascontiguousarray(offs, np.float32)
    counts = np.empty(len(nr), np.int32)
    lib.rescan_plane_counts(_fptr(p), a.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), len(p), _fptr(nr), _fptr(of),
        len(nr), ctypes.c_float(dist), _iptr(counts))
    return counts.astype(np.int64)


def plane_gather(pts: np.ndarray, nrm: np.ndarray, centers: np.ndarray,
                 normals: np.ndarray, dot_thr: float, dist_thr: float
                 ) -> np.ndarray:
    """(n_models, n_pts) uint8 inlier masks (OpenMP over models)."""
    lib = _load()
    p = np.ascontiguousarray(pts, np.float32)
    nn = np.ascontiguousarray(nrm, np.float32)
    c = np.ascontiguousarray(centers, np.float32)
    nr = np.ascontiguousarray(normals, np.float32)
    out = np.empty((len(nr), len(p)), np.uint8)
    lib.rescan_plane_gather(
        _fptr(p), _fptr(nn), len(p), _fptr(c), _fptr(nr), len(nr),
        ctypes.c_float(dot_thr), ctypes.c_float(dist_thr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def alias_build(weights: np.ndarray):
    """(prob, alias) tables of msh_discrete_distrib_t, bit-exact
    (lib/msh/msh_std.h:1863-1942)."""
    lib = _load()
    w = np.ascontiguousarray(weights, np.float64)
    prob = np.empty(len(w), np.float64)
    alias = np.empty(len(w), np.int64)
    lib.rescan_alias_build(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(w),
        prob.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return prob, alias


def smooth_graph(idx: np.ndarray, d2: np.ndarray, nrm: np.ndarray,
                 r2: float, dist_exp: int, angle_exp: int):
    """Deduped unordered smoothing edges + weights from an (n, k)
    radius-kNN result (rspf_compute_neighborhood weight formula)."""
    lib = _load()
    n, k = idx.shape
    ii = np.ascontiguousarray(idx, np.int32)
    dd = np.ascontiguousarray(d2, np.float32)
    nn = np.ascontiguousarray(nrm, np.float32)
    cap = n * k
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    w = np.empty(cap, np.float32)
    e = lib.rescan_smooth_graph(_iptr(ii), _fptr(dd), _fptr(nn), n, k,
                                ctypes.c_float(r2), int(dist_exp),
                                int(angle_exp), _iptr(src), _iptr(dst),
                                _fptr(w))
    return (np.stack([src[:e], dst[:e]], 1), w[:e].copy())


def csr_from_edges(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   n: int):
    """Symmetrized CSR (off, nbr, w) from unordered edges, neighbor order
    identical to the numpy concatenate + stable-argsort build."""
    lib = _load()
    E = len(src)
    s = np.ascontiguousarray(src, np.int32)
    d = np.ascontiguousarray(dst, np.int32)
    ww = np.ascontiguousarray(w, np.float32)
    off = np.empty(n + 1, np.int64)
    nbr = np.empty(2 * E, np.int32)
    wout = np.empty(2 * E, np.float32)
    lib.rescan_csr_from_edges(
        _iptr(s), _iptr(d), _fptr(ww), E, n,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _iptr(nbr),
        _fptr(wout))
    return off, nbr, wout


def pair_penalties(cent: np.ndarray, sig_inv: np.ndarray, cents: np.ndarray,
                   sig_invs: np.ndarray, mah_scale: float) -> np.ndarray:
    """One placement's 0.5*(ea+eb) midpoint-Mahalanobis penalties vs a
    batch (FastEnergy's per-set row; all inputs must be contiguous f64 —
    they are by construction in ops/energy.py, and this wrapper skips the
    copy checks because it sits on the SA per-iteration path)."""
    lib = _load()
    n = len(cents)
    out = np.empty(n, np.float64)
    lib.rescan_pair_penalties(
        cent.ctypes.data, sig_inv.ctypes.data, cents.ctypes.data,
        sig_invs.ctypes.data, n, mah_scale, out.ctypes.data)
    return out


def cov_update(cnt: np.ndarray, old_cells: np.ndarray,
               new_cells: np.ndarray) -> int:
    """Apply -1 over old_cells then +1 over new_cells (unique int64 ids)
    to the int32 count grid; returns the covered-cell delta."""
    lib = _load()
    return int(lib.rescan_cov_update(
        cnt.ctypes.data, old_cells.ctypes.data, len(old_cells),
        new_cells.ctypes.data, len(new_cells)))


def ransac_triplets(prob: np.ndarray, alias: np.ndarray, seed: int,
                    n_iter: int, reject_equal: bool) -> np.ndarray:
    """(n_iter, 3) index triplets from the alias distribution, draw-order
    bit-exact with utils/rng.MshDiscreteDistribution.sample; walls use
    reject_equal (b!=a, c!=b re-draws, rs_pointcloud_filters.cpp:146-154)."""
    lib = _load()
    p = np.ascontiguousarray(prob, np.float64)
    a = np.ascontiguousarray(alias, np.int64)
    out = np.empty((n_iter, 3), np.int64)
    lib.rescan_ransac_triplets(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(p),
        ctypes.c_uint32(seed), n_iter, int(reject_equal),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def overlap_counts(pa: np.ndarray, pb: np.ndarray, origin: np.ndarray,
                   res: np.ndarray, voxel: float, voxelize_inside: bool
                   ) -> Tuple[int, int, int]:
    """Occupancy counts (|A|, |B|, |A and B|) of two world-space point sets
    on the union voxel grid (isect_get_overlap_factor semantics; engine
    agreement with ops/voxel.py's numpy path is unit-tested)."""
    lib = _load()
    a = np.ascontiguousarray(pa, np.float32)
    b = np.ascontiguousarray(pb, np.float32)
    o = np.ascontiguousarray(origin, np.float32)
    r = np.ascontiguousarray(res, np.int32)
    out = np.empty(3, np.int64)
    lib.rescan_overlap_counts(
        _fptr(a), len(a), _fptr(b), len(b), _fptr(o), _iptr(r),
        ctypes.c_float(voxel), int(voxelize_inside),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return int(out[0]), int(out[1]), int(out[2])


def merge_shuffle(n: int, seed: int) -> np.ndarray:
    """The reference's deterministic Fisher-Yates merge permutation
    (rs_pointcloud.h:383-446), bit-exact with utils/rng.MshRand."""
    lib = _load()
    perm = np.empty(n, np.int32)
    lib.rescan_merge_shuffle(n, ctypes.c_uint32(seed), _iptr(perm))
    return perm


def meanfield_icm(U: np.ndarray, csr_off: np.ndarray, csr_nbr: np.ndarray,
                  csr_w: np.ndarray, n_mf: int, inv_temp: float,
                  Q0: np.ndarray, icm_mask: np.ndarray) -> np.ndarray:
    """Host mean-field + masked-ICM smoothing over the Potts MRF; semantics
    identical to the JAX engine in ops/labels.py (engine agreement is
    unit-tested). Returns the final label per node."""
    lib = _load()
    n, L = U.shape
    u = np.ascontiguousarray(U, np.float32)
    off = np.ascontiguousarray(csr_off, np.int32)
    nbr = np.ascontiguousarray(csr_nbr, np.int32)
    w = np.ascontiguousarray(csr_w, np.float32)
    q0 = np.ascontiguousarray(Q0, np.float32)
    mask = np.ascontiguousarray(icm_mask, np.uint8)
    n_icm = 0 if mask.size == 0 else mask.shape[0]
    out = np.empty(n, np.int32)
    lib.rescan_meanfield_icm(
        _fptr(u), _iptr(off), _iptr(nbr), _fptr(w), n, L, int(n_mf),
        ctypes.c_float(inv_temp), _fptr(q0), n_icm,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _iptr(out))
    return out


def abswap(U: np.ndarray, csr_off: np.ndarray, csr_nbr: np.ndarray,
           csr_w: np.ndarray, labels0: np.ndarray,
           n_cycles: int = 2) -> np.ndarray:
    """alpha-beta-swap graph-cut local optimization of the Potts MRF —
    the smoothing ORACLE matching the reference's gco swap(2) move space
    (rs_pointcloud_filters.cpp:955-968). Same (U, CSR) inputs as
    meanfield_icm; all costs must be integer-valued (they are by
    construction). Returns the optimized label per node."""
    lib = _load()
    n, L = U.shape
    u = np.ascontiguousarray(U, np.float32)
    off = np.ascontiguousarray(csr_off, np.int32)
    nbr = np.ascontiguousarray(csr_nbr, np.int32)
    w = np.ascontiguousarray(csr_w, np.float32)
    lab = np.ascontiguousarray(labels0, np.int32).copy()
    lib.rescan_abswap(_fptr(u), n, L, _iptr(off), _iptr(nbr), _fptr(w),
                      int(n_cycles), _iptr(lab))
    return lab


def union_find(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Root label per node over an undirected edge list."""
    lib = _load()
    s = np.ascontiguousarray(src, np.int64)
    d = np.ascontiguousarray(dst, np.int64)
    labels = np.empty(n, np.int32)
    lib.rescan_union_find(
        n, s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(s),
        _iptr(labels))
    return labels


class HostGrid:
    """Host uniform hash grid for radius queries (oracle / host fallback)."""

    def __init__(self, points: np.ndarray, cell: float):
        self._lib = _load()
        self._pts = np.ascontiguousarray(points, dtype=np.float32)
        self._handle = self._lib.rescan_grid_build(
            _fptr(self._pts), len(self._pts), ctypes.c_float(cell))

    def radius_search(self, queries: np.ndarray, radius: float, k: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """K nearest within strict radius per query -> (idx, d2, cnt);
        idx -1 where missing, results sorted ascending by distance."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        m = len(q)
        idx = np.empty((m, k), dtype=np.int32)
        d2 = np.empty((m, k), dtype=np.float32)
        cnt = np.empty(m, dtype=np.int32)
        self._lib.rescan_grid_radius_search(
            ctypes.c_void_p(self._handle), _fptr(self._pts), _fptr(q), m,
            ctypes.c_float(radius), k, _iptr(idx), _fptr(d2), _iptr(cnt))
        return idx, d2, cnt

    def __del__(self):
        try:
            self._lib.rescan_grid_free(ctypes.c_void_p(self._handle))
        except Exception:
            pass


def sa_run(cfg: dict, tables: dict, init: dict, follow=None):
    """Native simulated-annealing action loop (rescan_sa_run): bit-exact
    replica of ops/energy.simulated_annealing's Python loop. ``cfg``/
    ``tables``/``init`` are the marshalled dicts built by
    energy._marshal_sa. Returns (n_done, trace[n_done,10], mutations[m,3],
    out_items, out_scores, (init_score, max_score)); ``tables['past_uidx']``
    is mutated in place by linearize-ids."""
    lib = _load()
    n_iter = int(cfg["n_iter"])
    trace = np.zeros((n_iter, 10), np.float64)
    out_mut = np.zeros((n_iter + 1, 3), np.int64)
    out_n_mut = np.zeros(1, np.int64)
    cap_out = int(init["uidx"].size) + n_iter + 8
    out_arr = np.zeros((cap_out, 4), np.int64)
    out_scores = np.zeros(cap_out, np.float64)
    out_n = np.zeros(1, np.int64)
    out_init_max = np.zeros(2, np.float64)
    if follow is None:
        follow_a, n_follow = np.zeros(0, np.uint8), 0
    else:
        follow_a = np.ascontiguousarray(follow, np.uint8)
        n_follow = len(follow_a)

    def P(a):
        return ctypes.c_void_p(a.ctypes.data) if a.size else None

    n_done = lib.rescan_sa_run(
        n_iter, ctypes.c_uint32(cfg["seed"]), cfg["restart_prob"],
        cfg["init_temp"], cfg["min_temp"], P(cfg["weights4"]), cfg["wsum"],
        int(cfg["n_past"]), cfg["swap_thr"], cfg["replace_thr"],
        cfg["dup_pen"], cfg["mismatch_pen"], cfg["existed_bonus"],
        cfg["novel_bonus"], cfg["decay_a"], cfg["decay_b"],
        cfg["base_scale"], cfg["mah_scale"], P(cfg["pdf_full"]),
        P(cfg["pdf_noswap"]), int(tables["n_obj"]),
        P(tables["obj_static"]), P(tables["obj_uidx"]),
        P(tables["obj_class"]), P(tables["obj_sigma"]), P(tables["obj_pdf"]),
        P(tables["prop_off"]), P(tables["prop_trans"]),
        P(tables["prop_score"]), P(tables["prop_add_pdf"]),
        P(tables["prop_cent"]), P(tables["prop_sig"]),
        P(tables["cells_off"]), P(tables["cells"]),
        int(tables["n_extra"]), P(tables["ex_trans"]), P(tables["ex_cent"]),
        P(tables["ex_sig"]), P(tables["ex_cells_off"]), P(tables["ex_cells"]),
        int(tables["n_cells_total"]), int(tables["n_scn_valid"]),
        int(tables["n_past_arr"]), P(tables["past_off"]),
        P(tables["past_uidx"]), P(tables["past_class"]),
        P(tables["past_pos"]), P(tables["past_objidx"]),
        int(init["uidx"].size), P(init["uidx"]), P(init["arr_idx"]),
        P(init["objidx"]), P(init["ref"]), P(init["score"]),
        int(tables["scene_idx"]), int(tables["n_arr"]),
        P(follow_a), n_follow, P(trace), P(out_mut), P(out_n_mut),
        P(out_arr), P(out_scores), P(out_n), P(out_init_max))
    m = int(out_n_mut[0])
    n_out = int(out_n[0])
    return (int(n_done), trace[:n_done], out_mut[:m],
            out_arr[:n_out], out_scores[:n_out],
            (float(out_init_max[0]), float(out_init_max[1])))
