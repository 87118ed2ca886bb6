"""K1, the scoring search (gnn_kernel<false, *>), in per cent of its
roofline where it searches a set of slabs: the least time the searches
could take (the bytes of one search of the whole index a call, each query
read and written once and each index point read once,
scanbench/kernels_set.py, at HBM's rate) over the device time the
profiler gave the kernel in the traced window. None where the program
counts no query rows searched again over a set (it splits nothing)."""

from scanbench import kernels, kernels_set

KEY = "gated_min_set_requeries"


def read(record):
    counts = [r[s].get(KEY) for r in record["rescans"]
              for s in ("pose_proposal", "segment_transfer")]
    if not any(c is not None for c in counts):
        return None
    dev = sum(t for n, t in record.get("kernel_s", {}).items()
              if kernels.GNN_KERNELS["gated_min"] in n)
    if dev <= 0.0:
        return None
    nbytes = kernels_set.k1_bytes(record["launches"],
                                  int(sum(c or 0 for c in counts)))
    return 100.0 * nbytes / kernels.HBM_BYTES_PER_S / dev
