"""K1, the scoring search (gnn_kernel<false, *>), in per cent of its
roofline: the least time its launches could take (each launch's bytes at
HBM's rate, scanbench/kernels.py) over the device time the profiler gave
its kernel in the traced window."""

from scanbench import kernels


def read(record):
    dev = sum(t for n, t in record.get("kernel_s", {}).items()
              if kernels.GNN_KERNELS["gated_min"] in n)
    if dev <= 0.0:
        return None
    bound = sum(kernels.gnn_bound_s(k, m, n)
                for k, m, n in record["launches"] if k == "gated_min")
    return 100.0 * bound / dev
