"""Device milliseconds of the port's per-pair sum, fused multiply-add,
6x6 solve and ICP-tail kernels at their main-path shapes, for the
checkout this file sits in or another one, so that two versions of the
port can be timed in turns on the same card by one measure: chip_smoke.py's ``kernel_ms`` and
``queued_ms`` (CUDA events around back-to-back calls queued behind a spin
kernel, every call launching its kernel once), which also times the
library call beside each kernel.

    python tools/time_torch_port_kernels.py [--package-root DIR]

``--package-root``: the directory holding the ``rescan_tpu_torch`` to time
(default: this checkout). On rows made from a fixed seed it times: the ICP
step's rounds 3 and 4 of per-pair sums at 64 pairs x 4,096 points
(``icp._specs``; beside torch.bmm's Gram product of the same columns); one
fused multiply-add over 4,194,304 entries (``pairsum.fma`` where the
package has it, else the chain c * 1, then a * b; beside torch.addcmul);
the 6x6 solve of 69 systems (beside torch.linalg.solve_ex); where the
package has it, the ICP step's tail of 69 pairs on the same systems
(beside the launch floor, an empty kernel); where the package has it,
the ICP step's head, each of its four forms at 69 pairs x 4,096 and x
8,192 points (the bench ICP launch's shape and the path's largest head
launch) against a 99,290-row scene (the level-2 slab), the forms chained
through the package's sums, each beside its bound (chip_smoke's
``head_bound``: its bytes over 3.35 TB/s) and the launch floor. Each kernel's
output is held to its plain version bit for bit first. Prints one JSON
line: the package root, the card (name and power limit, as nvidia-smi
gives them) and the times. Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=ROOT)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                   # this checkout's measure
    sys.path.insert(0, root)                  # the package it times

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_port_kernels: no CUDA device")
    from rescan_tpu_torch.ops import gnn, icp, lu6, pairsum
    if not os.path.dirname(pairsum.__file__).startswith(root):
        raise SystemExit(f"time_torch_port_kernels: imported {pairsum.__file__}"
                         f", not the package under {root}")

    cuda = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    rows = {}
    for round_ in (3, 4):
        b, n, k = 64, 4096, 7 if round_ == 3 else 15
        spec = icp._specs(n, False)[round_ - 3]
        x = rng.normal(size=(b, n, k)).astype(np.float32)
        x[rng.random((b, n)) < 0.2] = 0.0
        x = torch.from_numpy(x).to(cuda)
        # the launch alone: the older wrapper copies the spec to the card
        # and waits on the copy in every call
        if hasattr(pairsum, "_spec_key"):
            key = pairsum._spec_key(spec)
        else:
            key = pairsum.as_spec(spec).to(cuda)

        def kern(x=x, key=key, n=n):
            return pairsum._launch(x, key, 0, n, None)
        if not torch.equal(kern().cpu(), pairsum.pairsum_ref(x.cpu(), spec)):
            raise SystemExit(f"pairsum round {round_}: differs from the "
                             f"plain version")
        xt = x.transpose(1, 2)
        rows[f"pairsum round {round_}, {b} x {n}"] = {
            "ms": cs.kernel_ms(kern, "pairsum"),
            "library_ms": cs.queued_ms(lambda: torch.bmm(xt, x))[0]}

    m = 4_194_304
    a, b, c = (torch.from_numpy(rng.normal(size=m).astype(np.float32))
               .to(cuda) for _ in "abc")
    if hasattr(pairsum, "fma"):
        def fused():
            return pairsum.fma(a, b, c)
    else:
        one = torch.ones((), device=cuda)

        def fused():
            return pairsum.fma_chains(
                [pairsum.Chain([(c, one), (a, b)])], a.shape)[0]
    if not torch.equal(fused().view(torch.int32),
                       gnn._fma32(a, b, c).view(torch.int32)):
        raise SystemExit("fma: differs from the plain version")
    rows[f"fma, {m} entries"] = {
        "ms": cs.kernel_ms(fused, "fma"),
        "library_ms": cs.queued_ms(lambda: torch.addcmul(c, a, b))[0]}

    s = 69
    g = rng.normal(size=(s, 6, 6)).astype(np.float32)
    cm = torch.from_numpy(g @ g.transpose(0, 2, 1) + 6 * np.eye(
        6, dtype=np.float32)).to(cuda)
    rhs = torch.from_numpy(rng.normal(size=(s, 6)).astype(np.float32)).to(cuda)
    if not lu6.same_bits(lu6.solve(cm, rhs).cpu(),
                         lu6.solve_ref(cm.cpu(), rhs.cpu())):
        raise SystemExit("lu6: differs from the plain version")
    rows[f"lu6, {s} systems"] = {
        "ms": cs.kernel_ms(lambda: lu6.solve(cm, rhs), "lu6"),
        "library_ms": cs.queued_ms(
            lambda: torch.linalg.solve_ex(cm, rhs)[0])[0]}

    if "icp_tail" in pairsum.KERNELS:
        # the ICP tail over the same 69 systems (undamped: the tail damps
        # them), with seeded weight totals, counts, centroids and poses
        s4 = torch.cat([cm.reshape(s, 36), -rhs, torch.rand(
            s, 1, device=cuda)], 1)
        args = (s4, 1 + 99 * torch.rand(s, device=cuda),
                torch.randint(1, 4096, (s,), device=cuda),
                torch.randn(s, 3, device=cuda), torch.randn(s, 4, 4,
                                                            device=cuda),
                torch.rand(s, device=cuda),
                torch.ones(s, dtype=torch.bool, device=cuda), 6)
        got = icp._icp_tail(*args)
        want = icp._icp_tail_ref(*(a.cpu() if torch.is_tensor(a) else a
                                   for a in args))
        if not icp.same_tail([g.cpu() for g in got], want):
            raise SystemExit("icp_tail: differs from the plain version")
        rows[f"icp_tail, {s} pairs"] = {
            "ms": cs.kernel_ms(lambda: icp._icp_tail(*args), "icp_tail"),
            "launch_floor_ms": cs.queued_ms(
                lambda: pairsum.run("empty", cuda))[0]}

    if "icp_head" in pairsum.KERNELS:
        rows.update(_head_rows(cs, cuda, rng))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"package_root": root, "card": card,
                      "timing": cs.TIMING, "rows": rows}))
    return 0


def _head_rows(cs, cuda, rng) -> dict:
    """The ICP head's four forms at the bench ICP launch's shape and at the
    path's largest head launch, each held to the plain version bit for
    bit on CPU copies, then timed beside its byte bound."""
    import numpy as np
    import torch
    from rescan_tpu_torch.ops import icp, lu6, pairsum
    b, m = 69, 99_290
    rows = {}
    for n in (4096, 8192):
        idx = rng.integers(0, m, (b, n)).astype(np.int32)
        idx[rng.random((b, n)) < 0.3] = -1
        nrm = rng.normal(size=(m, 3))
        a = [torch.from_numpy(v).to(cuda) for v in (
            idx, (rng.random((b, n)) * 0.01).astype(np.float32),
            rng.uniform(0.5, 1.0, (b, n)).astype(np.float32),
            np.arange(n)[None] < rng.integers(n // 2, n + 1, (b, 1)),
            rng.normal(size=(m, 3)).astype(np.float32),
            (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
                np.float32))]
        q = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(
            np.float32)).to(cuda)
        ops = {icp.HEAD_A: (*a, np.float32(0.1))}
        x1, w0, p2, n2 = icp._icp_head(icp.HEAD_A, *ops[icp.HEAD_A])
        s1 = pairsum.sums(x1, icp._SPEC1)
        ops[icp.HEAD_B] = (x1, s1)
        x2, _ = icp._icp_head(icp.HEAD_B, x1, s1)
        ops[icp.HEAD_C] = (x1, w0, s1, pairsum.sums(x2, icp._SPEC2), q, p2)
        x3, = icp._icp_head(icp.HEAD_C, *ops[icp.HEAD_C])
        ops[icp.HEAD_D] = (x3, n2, pairsum.sums(x3, icp._specs(n, False)[0]))
        for form, args in ops.items():
            got = icp._icp_head(form, *args)
            want = icp._icp_head_ref(form, *(v.cpu() if torch.is_tensor(v)
                                              else v for v in args))
            for g, w in zip(got, want):
                g = g.cpu()
                if not (lu6.same_bits(g, w) if g.is_floating_point()
                        else torch.equal(g, w)):
                    raise SystemExit(f"icp_head form {form} {b} x {n}: "
                                     f"differs from the plain version")
            ms = cs.kernel_ms(lambda f=form, v=args: icp._icp_head(f, *v),
                              "icp_head")
            bound, by, _ = cs.head_bound(form, args, got)
            rows[f"icp_head form {'ABCD'[form]}, {b} x {n}"] = {
                "ms": ms, "bound_ms": bound, "bound_by": by,
                "share_of_bound": bound / ms}
    rows[f"icp_head form A, {b} x 4096"]["launch_floor_ms"] = cs.queued_ms(
        lambda: pairsum.run("empty", cuda))[0]
    return rows


if __name__ == "__main__":
    sys.exit(main())
