"""Seconds per substage of the port's bench rescan on the card, for the
checkout this file sits in or another one, so that two versions of the
port can be timed in turns on the same card.

    python tools/time_torch_port_stages.py [--package-root DIR] [--runs N]

``--package-root``: the directory holding the ``rescan_tpu_torch`` to time
(default: this checkout). Writes bench.py's 2-scan sequence
(``rescan_tpu_torch.sequences.write_bench_sequence``) afresh for each run,
runs the driver on ``cuda:0`` once to build the kernels and warm up, then
``--runs`` more times, and prints one JSON line: the package root, the
card (name and power limit, as nvidia-smi gives them) and every timed
run's pose_proposal and segment_transfer substages in seconds. Needs a
CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=ROOT)
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_port_stages: no CUDA device")
    from rescan_tpu_torch import sequences
    from rescan_tpu_torch.pipeline import driver

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    runs = []
    with tempfile.TemporaryDirectory() as work:
        for k in range(args.runs + 1):
            seq_root = os.path.join(work, f"bench_{k}")
            class_file = sequences.write_bench_sequence(seq_root)
            profiles = []
            cwd = os.getcwd()
            os.chdir(seq_root)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    driver.run_sequence(sequences.SEQ_NAME, class_file,
                                        profiles=profiles,
                                        devices=[torch.device("cuda", 0)])
            finally:
                os.chdir(cwd)
            torch.cuda.synchronize()
            if k:
                p = profiles[0]
                runs.append({s: {n: round(v, 4) for n, v in p[s].items()}
                             for s in ("pose_proposal", "segment_transfer")})
    print(json.dumps({"package_root": root, "card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
