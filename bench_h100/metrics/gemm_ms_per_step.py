"""gemm_ms_per_step: device milliseconds of the cuBLAS kernels (the
residual's extrapolation, lift and divergence products) in the traced
chunk's replayed steps, per step."""

from bench_h100.metrics.common import replay_ops, traced_steps
from bench_h100.trace import kernel_class


def read(rec):
    ops = replay_ops(rec)
    if not ops:
        return None
    gemm = [o for o in ops if kernel_class(o.name) == "GEMM (cuBLAS)"]
    if not gemm:
        return None
    return 1e3 * sum(o.end - o.start for o in gemm) / traced_steps(rec)
