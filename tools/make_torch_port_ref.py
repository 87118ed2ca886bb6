"""Write tests/data/torch_port_small_ref.npz: the JAX package's outputs for
the small 2-scan sequence (rescan_tpu_torch.sequences), which the port is
held to where JAX is not installed (chip_smoke.py's parity phase).

    JAX_PLATFORMS=cpu RESCAN_DEVICES=1 python tools/make_torch_port_ref.py

Runs the JAX driver on the CPU on one device (RESCAN_DEVICES=1 keeps the
stages off the multi-device mesh path). tests/test_torch_pipeline.py
checks that the current JAX package still reproduces the file exactly.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=REF_PATH)
    args = ap.parse_args(argv)
    os.environ.setdefault("RESCAN_DEVICES", "1")
    with tempfile.TemporaryDirectory() as d:
        out = jax_small_outputs(d)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
