"""Batched point-to-plane ICP — the port of rescan_tpu/ops/icp.py.

Every (object, pose) pair of a batch iterates together; per-pair
convergence is an ``active`` mask, and the loop runs while
``it < max_iter`` and some pair is active. Correspondences come from K2
(ops/gnn.py ``nearest_gated``) against the scene slab.

Semantics mirror the reference (lib/rs/icp.h:416-500) and the JAX
package, quirks included:

* correspondences: nearest scene point within the current max_dist whose
  normal passes ``max(dot, 0) >= cos(max_angle)``;
* weights ``(1 - d2 / max_dist) * dot`` (d2 squared, max_dist not);
* outlier rejection: weights zeroed where ``d2 > 2.5 * std(d2)`` over the
  accepted set (squared distances, against the std alone);
* update: Low '04 linearisation about the weighted source centroid, the
  6x6 normal system with the same Tikhonov damping, composed as
  ``Trans(c1) Trans(t) Rx Ry Rz Trans(-c1) @ T``;
* loop: stop a pair when ``|err - prev| < 1e-5`` after iteration 5;
  ``max_dist <- max(0.95 * max_dist, 0.05)`` each iteration, in f32.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..utils import timing
from . import gnn, lu6, pairsum, search, xla_math
from .pairsum import BLOCKED, BLOCKED_TAIL, CHAIN, ONE, WINDOW

# XLA folds ``1e-6 * tr / 6.0`` (icp.py:161) into one constant
_DAMP = np.float32(1.66666666e-07)
# the damping's addend (icp.py:161), has_corrs's least weight total
# (:143), wsafe's floor (:144)
_DAMP_ADD = 1e-20
_MIN_WSUM = 1e-7
_WSUM_FLOOR = 1e-30


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for batches of small matrices as XLA's dot computes it:
    per entry an FMA chain over the inner index from the first product
    (the plain chains of ``pairsum.Chain``)."""
    terms = [(a[..., :, k, None], b[..., None, k, :])
             for k in range(a.shape[-1])]
    shape = torch.broadcast_shapes(terms[0][0].shape, terms[0][1].shape)
    return pairsum.Chain(terms).plain(shape)


def _transform(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor,
               nrm: torch.Tensor):
    """``(R p + t, R n)`` (icp.py:101-102, score.py:149-150) in XLA's
    order, both in one launch: per output ``fma(R[i,2], p2, fma(R[i,1],
    p1, R[i,0] * p0))``, then ``+ t`` rounded on its own."""
    def terms(v):
        return [(R[:, None, :, j], v[..., j, None]) for j in range(3)]
    return tuple(pairsum.fma_chains(
        [pairsum.Chain(terms(pts), add=t[:, None, :]),
         pairsum.Chain(terms(nrm))], pts.shape))


def _cross(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``jnp.cross(p, n)`` (icp.py:151): each ``a*b - c*d`` as
    ``fma(a, b, -(c*d))``, as XLA contracts it (one launch)."""
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    pairsum.fma_chains(
        [pairsum.Chain([(p[..., k], n[..., i]), (p[..., i], n[..., k])],
                       neg_first=True)
         for i, k in ((1, 2), (2, 0), (0, 1))],
        p.shape[:-1], outs=list(out.unbind(-1)))
    return out


def _rotation_xyz(ax, ay, az):
    """R = Rx(ax) @ Ry(ay) @ Rz(az) (icp.h:288-290), with XLA's f32 cos
    and sin (ops/xla_math.py's plain versions)."""
    angles = torch.stack([ax, ay, az], -1)
    (cx, cy, cz), (sx, sy, sz) = (
        v.unbind(-1) for v in (xla_math.cos_ref(angles),
                               xla_math.sin_ref(angles)))
    one = torch.ones_like(ax)
    zero = torch.zeros_like(ax)
    rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cx, -sx], -1),
                      torch.stack([zero, sx, cx], -1)], -2)
    ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    rz = torch.stack([torch.stack([cz, -sz, zero], -1),
                      torch.stack([sz, cz, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return _matmul(_matmul(rx, ry), rz)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's (``vsqrtps``): the
    f64 one rounded to f32 (53 >= 2 * 24 + 2 bits). torch's own f32 sqrt
    on the CPU misses it by an ulp on some arguments."""
    return x.double().sqrt().float()


def div(x: torch.Tensor, s) -> torch.Tensor:
    """x / s as a true division, s a constant: on the card a tensor
    divided by a Python scalar is multiplied by its reciprocal, so s goes
    in as a tensor on x's device."""
    return x / torch.tensor(float(s), dtype=x.dtype, device=x.device)


def cos_gate_of(max_angle) -> float:
    """cos(max_angle) formed in f32, as the reference's jitted code forms
    it (icp.py:92)."""
    return float(torch.cos(torch.tensor(np.float32(max_angle))))


# the step's four rounds of sums (ops/pairsum.py), over these columns
_SPEC1 = [(WINDOW, 0, ONE), (WINDOW, 1, ONE)]            # ok, d2
_SPEC2 = [(WINDOW, 0, ONE)]                              # (d2 - mean)^2
# C's entries that Eigen's sums of its slices reach in whole 16-lane
# packets; the rest are BLOCKED_TAIL (ops/pairsum.py)
_C_PACKED = 36 - 36 % 16


def _specs(n: int, single: bool):
    """Rounds 3 (w; w q; w p2) and 4 (C[i, j] over w j6[i] and j6[j]; b
    over ddn and w j6; e2 over w and ddn^2) for n points per pair, in the
    orders of an XLA launch of many pairs or, ``single``, of one."""
    strided = pairsum.single_pair_kind(n, True) if single else CHAIN
    flat = pairsum.single_pair_kind(n, False) if single else CHAIN
    spec3 = ([(WINDOW, 0, ONE)] + [(strided, 0, 1 + i) for i in range(3)]
             + [(strided, 0, 4 + i) for i in range(3)])
    spec4 = ([(BLOCKED if 6 * i + j < _C_PACKED else BLOCKED_TAIL, i, 6 + j)
              for i in range(6) for j in range(6)]
             + [(strided, 12, i) for i in range(6)] + [(flat, 13, 14)])
    return spec3, spec4

Sums = Callable[[torch.Tensor, list], torch.Tensor]


def _icp_step(obj_pts, obj_nrm, obj_mask, index, scene_pts, scene_nrm, T,
              err, dist: np.float32, active, it: int, cos_gate: float,
              sums: Optional[Sums] = None, single: bool = False):
    """One iteration for every pair; returns (T, err, active).

    Every sum over a pair's points is ``pairsum`` in the order XLA's
    compiled reference adds it, and every product and fused multiply-add
    around them is formed as XLA forms it (ops/pairsum.py lists both), so
    a step from the same state equals the JAX package's bit for bit. The
    sums come in four dependent rounds (ok count and d2; squared
    deviations; w, w*q and w*p2; the normal system and the error); the
    per-point work before each is one ``_icp_head`` form, the per-pair
    work after the last one ``_icp_tail``. On the card nothing in the step
    waits for the device. ``sums(x, spec)``: the (B, Q) totals of one
    round over the whole point axis; with each pair's points split over
    shards (parallel/mesh.py, the sp mode) it continues the chains shard
    after shard. ``pairsum.sums`` when None. ``single``: follow the orders
    XLA compiles for a launch of one pair (see ``_specs``)."""
    sums = sums or pairsum.sums
    B, N, _ = obj_pts.shape
    spec3, spec4 = _specs(N, single)
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    q, qn = _transform(R, t, obj_pts, obj_nrm)
    # inactive pairs query from far away: their blocks are near no tile
    q = torch.where(active[:, None, None], q, 2e6)
    idx, d2, dot = search.nearest_gated(index, q.reshape(B * N, 3),
                                        qn.reshape(B * N, 3), dist, cos_gate)
    x1, w0, p2, n2 = _icp_head(HEAD_A, idx.reshape(B, N), d2.reshape(B, N),
                               dot.reshape(B, N), obj_mask, scene_pts,
                               scene_nrm, dist)
    s1 = sums(x1, _SPEC1)
    x2, cnt_raw = _icp_head(HEAD_B, x1, s1)
    s2 = sums(x2, _SPEC2)
    x3, = _icp_head(HEAD_C, x1, w0, s1, s2, q, p2)
    s3 = sums(x3, spec3)
    x4, c1 = _icp_head(HEAD_D, x3, n2, s3)
    s4 = sums(x4, spec4)
    return _icp_tail(s4, s3[:, 0], cnt_raw, c1, T, err, active, it)


# the step's head (``_icp_head``): one form after K2 and after each of the
# first three rounds of sums
HEAD_A, HEAD_B, HEAD_C, HEAD_D = range(4)
HEAD_FORMS = (HEAD_A, HEAD_B, HEAD_C, HEAD_D)
# the 2.5-sigma rejection (icp.py:138-139): every weight is kept where the
# pair's std is at most _STD_FLOOR, else where d2 <= _SIGMAS * std
_STD_FLOOR = 1e-6
_SIGMAS = 2.5
_f32, _i32, _i64, _bool = torch.float32, torch.int32, torch.int64, torch.bool
# per form, its operands (shape over B pairs of N points and M scene rows,
# dtype) then its outputs, in csrc/pairsum.cu HeadIo's order
_HEAD_OPERANDS = {
    HEAD_A: ((("B", "N"), _i32), (("B", "N"), _f32), (("B", "N"), _f32),
             (("B", "N"), _bool), (("M", 3), _f32), (("M", 3), _f32)),
    HEAD_B: ((("B", "N", 2), _f32), (("B", 2), _f32)),
    HEAD_C: ((("B", "N", 2), _f32), (("B", "N"), _f32), (("B", 2), _f32),
             (("B", 1), _f32), (("B", "N", 3), _f32), (("B", "N", 3), _f32)),
    HEAD_D: ((("B", "N", 7), _f32), (("B", "N", 3), _f32), (("B", 7), _f32)),
}
_HEAD_OUTPUTS = {
    HEAD_A: ((("B", "N", 2), _f32), (("B", "N"), _f32),
             (("B", "N", 3), _f32), (("B", "N", 3), _f32)),
    HEAD_B: ((("B", "N", 1), _f32), (("B",), _i64)),
    HEAD_C: ((("B", "N", 7), _f32),),
    HEAD_D: ((("B", "N", 15), _f32), (("B", 3), _f32)),
}


def _icp_head(form: int, *args) -> tuple:
    """One form of the step's per-point work between its rounds of sums,
    as a tuple of its outputs:

    * ``HEAD_A`` (idx (B, N) int32 from K2, d2, dot, obj_mask, scene_pts,
      scene_nrm, dist): round 1's operands x1 (B, N, 2) = [ok, d2 where
      ok], the weights w0 (B, N) and the gathered p2, n2 (B, N, 3);
    * ``HEAD_B`` (x1, round 1's totals s1 (B, 2)): round 2's operand (B,
      N, 1) and the raw counts (B,) int64;
    * ``HEAD_C`` (x1, w0, s1, round 2's totals s2 (B, 1), q, p2): round
      3's operands [w, q, p2] (B, N, 7), the 2.5-sigma rejection applied;
    * ``HEAD_D`` (the round-3 operands, n2, their totals s3 (B, 7)): round
      4's operands (B, N, 15) and the centroid c1 (B, 3).

    On CUDA tensors one ``icp_head_kernel`` launch (csrc/pairsum.cu, a
    CTA per tile of 128 points); on CPU tensors ``_icp_head_ref``, which
    it equals bit for bit. K2's indices must lie below the scene's rows
    (the kernel gathers without a check)."""
    if not args[0].is_cuda:
        pairsum._count(pairsum.PLAIN_CALLS, "icp_head")
        return _icp_head_ref(form, *args)
    ops, outs, cargs = head_operands(form, *args)
    if outs[0].numel():
        pairsum.run("icp_head", ops[0].device, *cargs)
    return outs


def head_operands(form: int, *args) -> tuple:
    """(operands, outputs, C arguments of ``icp_head_run`` but the stream)
    of one ``_icp_head`` launch: the operands checked, made contiguous and
    16-byte aligned (the kernel copies its tiles as float4s; keep them
    alive through the call), the outputs allocated beside them."""
    n_ops = len(_HEAD_OPERANDS[form])
    ops = args[:n_ops]
    B, N = ops[0].shape[:2]
    dims = {"B": B, "N": N, "M": args[4].shape[0] if form == HEAD_A else 0}
    want = [(tuple(dims.get(d, d) for d in shape), dtype)
            for shape, dtype in _HEAD_OPERANDS[form]]
    if N == 0 or len(args) != n_ops + (form == HEAD_A) or any(
            not torch.is_tensor(v) or tuple(v.shape) != shape
            or v.dtype != dtype or v.device != ops[0].device
            for v, (shape, dtype) in zip(ops, want)):
        raise ValueError(
            f"icp_head form {form}: want operands {want} (and dist for "
            f"form {HEAD_A}) on one device, N > 0, got " + ", ".join(
                f"{tuple(v.shape)} {v.dtype} {v.device}" if torch.is_tensor(
                    v) else repr(v) for v in args))
    ops = tuple(v.contiguous() for v in ops)
    ops = tuple(v if v.data_ptr() % 16 == 0 else v.clone() for v in ops)
    outs = tuple(torch.empty(tuple(dims.get(d, d) for d in shape),
                             dtype=dtype, device=ops[0].device)
                 for shape, dtype in _HEAD_OUTPUTS[form])
    dist = args[-1] if form == HEAD_A else 0.0
    cargs = (form, (ctypes.c_void_p * 6)(*(v.data_ptr() for v in ops)),
             (ctypes.c_void_p * 4)(*(v.data_ptr() for v in outs)), B, N,
             *(float(np.float32(v)) for v in (dist, _WSUM_FLOOR, _STD_FLOOR,
                                               _SIGMAS)))
    return ops, outs, cargs


def head_info(form: int, device) -> dict:
    """Residency of one ``icp_head_kernel`` form on the CUDA ``device``:
    CTAs per SM by the occupancy calculator, registers per thread, static
    shared bytes per CTA, local (spill) bytes per thread."""
    lib = pairsum.load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = lib.icp_head_info(int(form), out)
    if rc != 0:
        raise RuntimeError(f"icp_head: kernel info failed, cudaError {rc}")
    return dict(zip(("ctas_per_sm", "registers", "shared_bytes",
                     "local_bytes"), out))


def _icp_head_ref(form: int, *args) -> tuple:
    """The plain PyTorch ``_icp_head`` (CPU tensors only), in the order
    XLA computes icp.py:123-157: the step's torch code between its rounds
    of sums, each form reading ``ok`` and the masked d2 from round 1's
    operands."""
    if any(torch.is_tensor(v) and v.device.type != "cpu" for v in args):
        raise ValueError("icp_head: the plain version takes CPU tensors")
    if form == HEAD_A:
        idx, d2, dot, obj_mask, scene_pts, scene_nrm, dist = args
        idx = idx.long()
        ok = (idx >= 0) & obj_mask
        idx_safe = idx.clamp_min(0)
        p2 = scene_pts[idx_safe]
        n2 = scene_nrm[idx_safe]
        w = torch.where(ok, (1.0 - div(d2, dist)) * dot, 0.0)
        return (torch.stack([ok.float(), torch.where(ok, d2, 0.0)], -1), w,
                p2, n2)
    if form == HEAD_D:
        x3, n2, s3 = args
        w, q, p2 = x3[..., 0], x3[..., 1:4], x3[..., 4:7]
        wsum = s3[:, 0]
        wsafe = wsum.clamp_min(_WSUM_FLOOR)
        c1 = s3[:, 1:4] / wsafe[:, None]
        c2 = s3[:, 4:7] / wsafe[:, None]
        p = q - c1[:, None, :]
        d = p - (p2 - c2[:, None, :])
        cxn = _cross(p, n2)
        ddn = d[..., 0] * n2[..., 0] + d[..., 1] * n2[..., 1] \
            + d[..., 2] * n2[..., 2]
        # 6x6 normal system: J = [c; n] per correspondence (Low '04)
        j6 = torch.cat([cxn, n2], -1)                        # (B, N, 6)
        wj6 = w[..., None] * j6
        return torch.cat([wj6, j6, ddn[..., None], w[..., None],
                          (ddn * ddn)[..., None]], -1), c1
    x1, s1 = args[0], args[2 if form == HEAD_C else 1]
    ok = x1[..., 0] > 0
    d2 = x1[..., 1]
    cnt_raw = s1[:, 0].long()
    cnt = cnt_raw.clamp_min(1)
    if form == HEAD_B:
        # 2.5-sigma rejection on squared distances (icp.h:393-401)
        mean = s1[:, 1] / cnt
        dev = d2 - mean[:, None]
        return torch.where(ok, dev * dev, 0.0)[..., None], cnt_raw
    _, w, _, s2, q, p2 = args
    var = s2[:, 0] / cnt
    std = _sqrt(var)
    keep = (std[:, None] <= _STD_FLOOR) | (d2 <= _SIGMAS * std[:, None])
    w = torch.where(keep, w, 0.0)
    return (torch.cat([w[..., None], q, p2], -1),)


def _icp_tail(s4, wsum, cnt_raw, c1, T, err, active, it: int):
    """The step after its last round of sums, per pair: (T, err, active)
    from round 4's totals ``s4`` (B, 43: C, b negated, e2), round 3's
    weight totals ``wsum`` (B,), round 1's counts ``cnt_raw`` (B,
    int64), the centroid ``c1`` (B, 3) and the state. On CUDA tensors
    one ``icp_tail_kernel`` launch (csrc/pairsum.cu, a warp per pair);
    on CPU tensors ``_icp_tail_ref``, which it equals bit for bit."""
    if not s4.is_cuda:
        pairsum._count(pairsum.PLAIN_CALLS, "icp_tail")
        return _icp_tail_ref(s4, wsum, cnt_raw, c1, T, err, active, it)
    B = s4.shape[0]
    want = ((s4, (B, 43), torch.float32), (wsum, (B,), torch.float32),
            (cnt_raw, (B,), torch.int64), (c1, (B, 3), torch.float32),
            (T, (B, 4, 4), torch.float32), (err, (B,), torch.float32),
            (active, (B,), torch.bool))
    if s4.stride(1) != 1 or any(
            tuple(v.shape) != shape or v.dtype != dtype or
            v.device != s4.device for v, shape, dtype in want):
        raise ValueError(
            "icp_tail: want s4 (B, 43) with unit column stride, wsum, "
            "cnt_raw (int64), c1 (B, 3), T (B, 4, 4), err, active (bool) "
            "on one device, got " + ", ".join(
                f"{tuple(v.shape)} {v.dtype} {v.device}" for v, _, _ in want))
    cnt_raw, c1, T, err, active = (v.contiguous() for v in (
        cnt_raw, c1, T, err, active))
    T_new = torch.empty_like(T)
    err_new = torch.empty_like(err)
    active_new = torch.empty_like(active)
    if B:
        pairsum.run("icp_tail", s4.device, s4.data_ptr(), s4.stride(0),
                    wsum.data_ptr(), wsum.stride(0), cnt_raw.data_ptr(),
                    c1.data_ptr(), T.data_ptr(), err.data_ptr(),
                    active.data_ptr(), T_new.data_ptr(), err_new.data_ptr(),
                    active_new.data_ptr(), B,
                    int(it > config.ICP_CONVERGE_MIN_ITER),
                    *(float(np.float32(v)) for v in (
                        _DAMP, _DAMP_ADD, _MIN_WSUM, _WSUM_FLOOR,
                        config.ICP_CONVERGE_DELTA)))
    return T_new, err_new, active_new


def same_tail(got, want) -> bool:
    """Whether two ``_icp_tail`` results (T, err, active) are equal bit for
    bit, a NaN equal to any NaN (the card and the CPU make NaNs of other
    payloads)."""
    return (lu6.same_bits(got[0], want[0]) and lu6.same_bits(got[1], want[1])
            and torch.equal(got[2], want[2]))


def _damped_system(s4):
    """(C + eye * damp, b) of round 4's totals (icp.py:156-161): the
    trace summed from C[0, 0], the damping added to all 36 entries (0 *
    damp off the diagonal: +0.0 for a -0.0 entry, NaN everywhere where
    damp is not finite)."""
    B = s4.shape[0]
    C = s4[:, :36].reshape(B, 6, 6)
    b = -s4[:, 36:42]
    tr = C[:, 0, 0]
    for k in range(1, 6):
        tr = tr + C[:, k, k]
    damp = tr * float(_DAMP) + _DAMP_ADD
    C = C + torch.eye(6, dtype=C.dtype, device=C.device)[None] \
        * damp[:, None, None]
    return C, b


def _icp_tail_ref(s4, wsum, cnt_raw, c1, T, err, active, it: int):
    """The plain PyTorch ``_icp_tail``, in the order XLA computes
    icp.py:160-182: the trace and damping, the 6x6 solve (ops/lu6.py),
    the error, the rotation (ops/xla_math.py's cos and sin, the products
    as XLA's dot chains) and the update."""
    B = s4.shape[0]
    has_corrs = (cnt_raw > 0) & (wsum > _MIN_WSUM)
    wsafe = wsum.clamp_min(_WSUM_FLOOR)
    x = lu6.solve_ref(*_damped_system(s4))
    x = torch.where(torch.isfinite(x), x, 0.0)

    new_err = _sqrt(s4[:, 42] / wsafe)
    Rx = _rotation_xyz(x[:, 0], x[:, 1], x[:, 2])
    upd = torch.zeros((B, 4, 4), dtype=torch.float32, device=T.device)
    upd[:, :3, :3] = Rx
    upd[:, :3, 3] = (c1 + x[:, 3:6]) - _matmul(Rx, c1[..., None])[..., 0]
    upd[:, 3, 3] = 1.0

    do_update = active & has_corrs
    T_new = torch.where(do_update[:, None, None], _matmul(upd, T), T)
    err_new = torch.where(do_update, new_err, err)
    converged = (it > config.ICP_CONVERGE_MIN_ITER) & \
        ((err - err_new).abs() < config.ICP_CONVERGE_DELTA)
    return T_new, err_new, active & has_corrs & ~converged


def icp_align_indexed(uobj_pts: torch.Tensor, uobj_nrm: torch.Tensor,
                      uobj_mask: torch.Tensor, obj_of_pair: torch.Tensor,
                      pair_valid: torch.Tensor, index: search.Index,
                      T_init: torch.Tensor, max_dist, max_angle,
                      max_iter: int = config.ICP_MAX_ITER,
                      sums: Optional[Sums] = None,
                      single: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 int]:
    """Refine B rigid transforms against the scene ``index``.

    uobj_pts/uobj_nrm: (O, N, 3) per-object padded points (pad_batch over
    the unique objects); uobj_mask: (O, N); obj_of_pair: (B,) row of each
    pair's object; pair_valid: (B,) False rows start inactive; T_init:
    (B, 4, 4). All on the index's device. ``sums``: the sums over a
    pair's points split over shards (the sp mode, see ``_icp_step``);
    the all-padding start mask goes through it too, so every shard
    starts and stops alike. ``single``: the sums in the order XLA
    compiles for a launch of one pair rather than of many (``_specs``);
    default: whether B is 1, as for the JAX package's launch of the same
    batch. The pipeline's refinements pass False: the JAX package pads
    those batches to 256 pairs.

    Returns (T, err, active, n_iter): refined transforms, final
    point-to-plane errors, the pairs still active when the loop stopped,
    and the number of iterations run.
    """
    sums = sums or pairsum.sums
    own = obj_of_pair.long()
    obj_pts = uobj_pts[own]
    obj_nrm = uobj_nrm[own]
    obj_mask = uobj_mask[own] & pair_valid[:, None]
    B = obj_pts.shape[0]
    single = B == 1 if single is None else single
    cos_gate = cos_gate_of(max_angle)
    scene_pts, scene_nrm = search.index_arrays(index)
    T = T_init.to(torch.float32)
    err = torch.full((B,), 1e6, dtype=torch.float32, device=T.device)
    dist = np.float32(max_dist)
    # all-padding rows start inactive
    active = sums(obj_mask.float()[..., None], [(WINDOW, 0, ONE)])[:, 0] > 0
    it = 0
    while it < max_iter and bool(timing.to_host(active.any())):
        T, err, active = _icp_step(obj_pts, obj_nrm, obj_mask, index,
                                   scene_pts, scene_nrm, T, err, dist,
                                   active, it, cos_gate, sums=sums,
                                   single=single)
        dist = np.maximum(np.float32(dist * np.float32(config.ICP_DIST_ANNEAL)),
                          np.float32(config.ICP_DIST_FLOOR))
        it += 1
    return T, err, active, it


def icp_align_batched(obj_pts: torch.Tensor, obj_nrm: torch.Tensor,
                      obj_mask: torch.Tensor, index: search.Index,
                      T_init: torch.Tensor, max_dist, max_angle,
                      max_iter: int = config.ICP_MAX_ITER
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """icp_align_indexed with one object row per pair: (T, err)."""
    B = obj_pts.shape[0]
    own = torch.arange(B, device=obj_pts.device)
    valid = torch.ones(B, dtype=torch.bool, device=obj_pts.device)
    T, err, _, _ = icp_align_indexed(obj_pts, obj_nrm, obj_mask, own, valid,
                                     index, T_init, max_dist, max_angle,
                                     max_iter=max_iter)
    return T, err


def prep_unique_batch(list_of_pts, list_of_nrm, n_min: int = 1):
    """pad_batch over UNIQUE objects, with the row axis padded to a power
    of two (>= 8). Padding rows are FAR points with empty masks —
    selectable only by invalid pairs, which start inactive."""
    pts, nrm, mask = pad_batch(list_of_pts, list_of_nrm, n_min=n_min)
    O, Np = mask.shape
    Op = max(1 << int(np.ceil(np.log2(max(O, 1)))), 8)
    if Op != O:
        pts = np.concatenate(
            [pts, np.full((Op - O, Np, 3), gnn.FAR, np.float32)])
        nrm = np.concatenate([nrm, np.zeros((Op - O, Np, 3), np.float32)])
        mask = np.concatenate([mask, np.zeros((Op - O, Np), bool)])
    return pts, nrm, mask


def pad_batch(list_of_pts, list_of_nrm, n_min: int = 1):
    """Pad a ragged list of (n_i, 3) arrays to (B, N_pad, 3) + mask.

    N_pad is the power of two covering the largest pair (>= 128, >=
    n_min). Each pair's points are Morton-sorted (tight kernel query
    blocks), padded replicate-last up to the next query-block boundary,
    then FAR beyond, so whole padding blocks are near no scene tile.
    """
    B = len(list_of_pts)
    n_max = max([len(p) for p in list_of_pts] + [n_min, 1])
    n_pad = max(1 << int(np.ceil(np.log2(n_max))), 128)
    bq = _block_for(n_pad)
    n_pad = max(n_pad, bq)
    pts = np.full((B, n_pad, 3), gnn.FAR, np.float32)
    nrm = np.zeros((B, n_pad, 3), np.float32)
    mask = np.zeros((B, n_pad), bool)
    for i, (p, n) in enumerate(zip(list_of_pts, list_of_nrm)):
        k = len(p)
        if k:
            order = gnn.morton_order(p)
            p = np.asarray(p, np.float32)[order]
            n = np.asarray(n, np.float32)[order]
        pts[i, :k] = p
        nrm[i, :k] = n
        mask[i, :k] = True
        edge = min(((k + bq - 1) // bq) * bq, n_pad)
        if k and edge > k:
            pts[i, k:edge] = p[k - 1]
            nrm[i, k:edge] = n[k - 1]
    return pts, nrm, mask


def _block_for(n_run: int) -> int:
    """The reference's replicate-padding granule for runs of ``n_run``
    points (pallas_nn.block_for), kept so padded batches equal the JAX
    package's."""
    if n_run <= 512:
        return 128
    if n_run <= 2048:
        return 256
    return 512
