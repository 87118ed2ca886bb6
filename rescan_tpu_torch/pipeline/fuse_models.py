"""Watertight model fusion via the external PoissonRecon / SurfaceTrimmer
binaries (not vendored by the reference either; scripts/fuse_models.py +
scripts/run_poisson_reconstruction.py).

For every model .ply in a folder: PoissonRecon with width 0.01, scale 1.25,
pointWeight 0.1, samplesPerNode 5, colors, density; the reconstruction
depth is parsed from stdout's "Cycle[0] ..." lines; SurfaceTrimmer trims at
depth - 1.5. Gated: callers skip fusion when the binaries are absent.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Optional


def run_poisson_recon(exe: str, input_ply: str, output_ply: str) -> Optional[int]:
    cmd = [exe, "--in", input_ply, "--out", output_ply,
           "--width", "0.01", "--scale", "1.25", "--pointWeight", "0.1",
           "--samplesPerNode", "5", "--colors", "--data", "1.5",
           "--density", "--verbose"]
    print("POISSON_CMD:", " ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, check=True)
    for line in reversed(res.stdout.decode("utf-8", "replace").splitlines()):
        tokens = line.split(" ")
        if tokens and tokens[0] == "Cycle[0]" and tokens[-1] != "0":
            for tok in tokens[1:3]:
                lb, sl = tok.find("["), tok.find("/")
                if lb >= 0 and sl > lb:
                    return int(tok[lb + 1:sl])
    return None


def run_surface_trimmer(exe: str, input_ply: str, output_ply: str,
                        trim_lvl: float, subs_lvl: float) -> None:
    cmd = [exe, "--in", input_ply, "--out", output_ply,
           "--trim", str(trim_lvl - subs_lvl), "--smooth", "0"]
    print("TRIMMER_CMD:", " ".join(cmd))
    subprocess.run(cmd, capture_output=True, check=True)


def fuse_models(poisson_exe: str, trimmer_exe: str, model_folder: str) -> None:
    paths = [os.path.join(model_folder, f) for f in os.listdir(model_folder)
             if f.endswith(".ply") and "temp" not in f]
    tmp = os.path.join(model_folder, "temp.ply")
    for p in paths:
        print(f"FUSE_MODELS: Working on {p}")
        depth = run_poisson_recon(poisson_exe, p, tmp)
        if depth is None:
            print(f"FUSE_MODELS: could not parse recon depth for {p}; skipping")
            continue
        run_surface_trimmer(trimmer_exe, tmp, p, depth, 1.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Poisson-reconstruct + trim every model .ply in a folder")
    ap.add_argument("model_folder")
    ap.add_argument("poisson_recon")
    ap.add_argument("trimmer")
    args = ap.parse_args(argv)
    fuse_models(args.poisson_recon, args.trimmer, args.model_folder)
    return 0


if __name__ == "__main__":
    sys.exit(main())
