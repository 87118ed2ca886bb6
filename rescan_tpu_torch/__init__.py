"""rescan_tpu_torch — the PyTorch + CUDA port of rescan_tpu.

The JAX package ``rescan_tpu`` stays the reference. This package ports
the rescan timestep (pose_proposal -> segment_transfer, driven by
``pipeline.driver``) with the same CLIs and files, on one device or on
a single-process mesh of several (``parallel.mesh``). Its one device kernel,
the gated nearest-neighbour search, is hand-written CUDA for Hopper
(``ops/csrc/gnn.cu``) with a plain PyTorch version beside it
(``ops/gnn.py``). Host code that never imports JAX — ``config``, ``io``,
``core`` (with the native C++ library), ``ops.{energy,planes,voxel}``,
``utils``, ``eval`` and the seg2rsdb/create_eval_files/fuse_models
stages — is imported from ``rescan_tpu``, not copied. This package never
imports JAX.
"""

import torch

__version__ = "0.1.0"

# Pose transforms and the ICP normal equations are f32 matmuls; TF32
# would move ICP poses by ~1e-3 against the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, cuda by default (with its index).
    Cuda without a card raises: the CPU is used only when it is asked for
    by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
