"""Write the JAX package's outputs that the port is held to where JAX is
not installed (chip_smoke.py):

    JAX_PLATFORMS=cpu RESCAN_DEVICES=1 python tools/make_torch_port_ref.py
    JAX_PLATFORMS=cpu RESCAN_DEVICES=1 python tools/make_torch_port_ref.py --eval

Without --eval: tests/data/torch_port_small_ref.npz, the outputs of the
small 2-scan sequence (rescan_tpu_torch.sequences). With --eval:
tests/data/torch_port_small3_ref.npz, the small 3-scan sequence of
``sequences.write_eval_sequence`` run with eval files, and its three
evaluators run: ``sequences.sequence_outputs`` (rescans 1 and 2, keys
"scan_00k/...") and the five ``sequences.METRICS`` (keys "metric/...").

Runs the JAX driver on the CPU on one device (RESCAN_DEVICES=1 keeps the
stages off the multi-device mesh path). tests/test_torch_pipeline.py and
tests/test_torch_eval.py check that the current JAX package still
reproduces the files exactly.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
REF_PATH = os.path.join(ROOT, "tests", "data", "torch_port_small_ref.npz")
EVAL_REF_PATH = os.path.join(ROOT, "tests", "data",
                             "torch_port_small3_ref.npz")


def jax_small_outputs(workdir: str) -> dict:
    """Run the JAX driver over the small sequence in ``workdir`` and read
    back its outputs for the rescan."""
    from rescan_tpu.pipeline import driver
    from rescan_tpu_torch import sequences

    class_file = sequences.write_small_sequence(workdir)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eval", action="store_true",
                    help="the small 3-scan sequence and its metrics")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    args.out = args.out or (EVAL_REF_PATH if args.eval else REF_PATH)
    os.environ.setdefault("RESCAN_DEVICES", "1")
    with tempfile.TemporaryDirectory() as d:
        out = (jax_small3_outputs if args.eval else jax_small_outputs)(d)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
