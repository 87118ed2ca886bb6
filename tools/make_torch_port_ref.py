"""Write the JAX package's outputs that the port is held to where JAX is
not installed (chip_smoke.py):

    JAX_PLATFORMS=cpu RESCAN_DEVICES=1 python tools/make_torch_port_ref.py
    JAX_PLATFORMS=cpu RESCAN_DEVICES=1 python tools/make_torch_port_ref.py --eval
    JAX_PLATFORMS=cpu RESCAN_DEVICES=1 python tools/make_torch_port_ref.py --bench

Without a flag: tests/data/torch_port_small_ref.npz, the outputs of the
small 2-scan sequence (rescan_tpu_torch.sequences). With --eval:
tests/data/torch_port_small3_ref.npz, the small 3-scan sequence of
``sequences.write_eval_sequence`` run with eval files, and its three
evaluators run: ``sequences.sequence_outputs`` (rescans 1 and 2, keys
"scan_00k/...") and the five ``sequences.METRICS`` (keys "metric/...").
With --bench: tests/data/torch_port_bench_ref.npz, the rescan of
``sequences.write_bench_sequence`` (bench.py's room, chair 0 and the sofa
moved): every proposal's pose and score, the arrangement, and the
level-1 labels as int16; the run's seconds are printed.

Runs the JAX driver on the CPU on one device (RESCAN_DEVICES=1 keeps the
stages off the multi-device mesh path). Its search index there is the
HashGrid, the JAX package's CPU engine, whose distances round otherwise
than the sorted slab's; with --slab every index is the slab, searched by
the Pallas kernel in interpret mode (the JAX package's accelerator path,
to which the port's kernel is bit-identical), and the file name takes a
``_slab`` before ``_ref`` (``--eval --slab``:
tests/data/torch_port_small3_slab_ref.npz, ~11 min on the CPU; ``--bench
--slab``: tests/data/torch_port_bench_slab_ref.npz, ~2 h, most of it the
scoring launches in interpret mode). tests/test_torch_pipeline.py and
tests/test_torch_eval.py check that the current JAX package still
reproduces the files exactly.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF_PATH = os.path.join(ROOT, "tests", "data", "torch_port_small_ref.npz")
EVAL_REF_PATH = os.path.join(ROOT, "tests", "data",
                             "torch_port_small3_ref.npz")
BENCH_REF_PATH = os.path.join(ROOT, "tests", "data",
                              "torch_port_bench_ref.npz")


def jax_small_outputs(workdir: str, bench: bool = False) -> dict:
    """Run the JAX driver over the small sequence (``bench``: bench.py's
    2-scan sequence) in ``workdir`` and read back its outputs for the
    rescan."""
    from rescan_tpu.pipeline import driver
    from rescan_tpu_torch import sequences

    class_file = (sequences.write_bench_sequence if bench
                  else sequences.write_small_sequence)(workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        driver.run_sequence(sequences.SEQ_NAME, class_file)
    finally:
        os.chdir(cwd)
    return sequences.read_outputs(workdir)


def jax_small3_outputs(workdir: str) -> dict:
    """Run the JAX driver with eval files over the small 3-scan sequence
    in ``workdir``, then the JAX package's three evaluators; its outputs
    for both rescans and the five metrics, as one flat dict."""
    from rescan_tpu.eval import (instance_transfer, semantic_instance,
                                 semantic_label)
    from rescan_tpu.pipeline import driver
    from rescan_tpu_torch import sequences

    class_file = sequences.write_eval_sequence(workdir, small=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        driver.run_sequence(sequences.SEQ_NAME, class_file,
                            eval_folder=os.path.join(workdir,
                                                     sequences.EVAL_DIR))
    finally:
        os.chdir(cwd)
    metrics = sequences.evaluate_sequence(
        workdir, evaluators=(semantic_label, instance_transfer,
                             semantic_instance))
    out = sequences.sequence_outputs(workdir)
    out.update({f"metric/{k}": np.float64(metrics[k])
                for k in sequences.METRICS})
    return out


def search_on_the_slab(monkeypatch=None) -> None:
    """Make the JAX stages build every search index as the sorted slab
    (``prefer_dense=True``, the accelerator engine; the Pallas kernel runs
    in interpret mode on the CPU). ``monkeypatch``: undo it with the
    test's monkeypatch; for good otherwise."""
    from rescan_tpu.ops import search
    build_index = search.build_index

    def slab_index(points, cell, normals=None, prefer_dense=None, **kw):
        return build_index(points, cell, normals=normals, prefer_dense=True,
                           **kw)

    if monkeypatch is None:
        search.build_index = slab_index
    else:
        monkeypatch.setattr(search, "build_index", slab_index)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--eval", action="store_true",
                       help="the small 3-scan sequence and its metrics")
    which.add_argument("--bench", action="store_true",
                       help="bench.py's 2-scan sequence")
    ap.add_argument("--slab", action="store_true",
                    help="search with the sorted slab and its Pallas "
                         "kernel instead of the CPU's HashGrid")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    args.out = args.out or (EVAL_REF_PATH if args.eval else BENCH_REF_PATH
                            if args.bench else REF_PATH)
    if args.slab and not args.out.endswith("_slab_ref.npz"):
        args.out = args.out.replace("_ref.npz", "_slab_ref.npz")
    os.environ.setdefault("RESCAN_DEVICES", "1")
    if args.slab:
        search_on_the_slab()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        if args.eval:
            out = jax_small3_outputs(d)
        else:
            out = jax_small_outputs(d, bench=args.bench)
    if args.bench:
        for k in ("class_ids", "instance_ids"):
            assert np.abs(out[k]).max() < 2 ** 15
            out[k] = out[k].astype(np.int16)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) in "
          f"{time.perf_counter() - t0:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
