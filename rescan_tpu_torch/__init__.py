"""rescan_tpu_torch — the PyTorch + CUDA port of rescan_tpu.

The JAX package ``rescan_tpu`` stays the reference. This package ports
the rescan timestep (pose_proposal -> segment_transfer, driven by
``pipeline.driver``) with the same CLIs and files, on one device or on
a single-process mesh of several (``parallel.mesh``). Its one device kernel,
the gated nearest-neighbour search, is hand-written CUDA for Hopper
(``ops/csrc/gnn.cu``) with a plain PyTorch version beside it
(``ops/gnn.py``). The host code it needs — ``config``, ``io``, ``core``,
``utils``, ``ops.{energy,planes,voxel}`` and the
seg2rsdb/create_eval_files/fuse_models stages — is the package's own copy,
held equal to the JAX package's by tests/test_torch_hostcopy.py. This
package imports neither JAX nor ``rescan_tpu``. It builds what it runs
from the repository's sources at first use, into ``rescan_tpu_torch/_build/``:
the native host library from ``native/rescan_host.cpp`` (g++,
``core/native.py``) and the CUDA kernel from ``ops/csrc/gnn.cu`` (nvcc,
``ops/gnn.py``).
"""

import collections

import torch

__version__ = "0.1.0"

# Calls of the eval, viewer and distance-field functions that did their
# device work on CPU tensors, by function name. On the card every such
# call should land on a CUDA tensor; chip_smoke.py holds the count at 0.
CPU_CALLS: collections.Counter = collections.Counter()

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


def count_if_cpu(name: str, device) -> None:
    """Count a call of ``name`` whose device work runs on ``device`` in
    CPU_CALLS when that is the CPU."""
    if torch.device(device).type == "cpu":
        CPU_CALLS[name] += 1
