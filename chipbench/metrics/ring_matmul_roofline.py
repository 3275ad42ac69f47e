"""ring_matmul_roofline: one rank's products' least time (2MNK over the
cards, over the dtype's peak, or their bytes over the memory bandwidth,
whichever is larger) over the device time of the GEMM kernels on rank 0
in one call (profiler), in percent."""
import re

from yardstick import peaks, trace

# library GEMM kernels (cuBLAS, CUTLASS), never a collective's
KERNELS = re.compile(r"^(?!.*nccl)(?=.*gemm)", re.IGNORECASE)


def read(obs):
    s = (obs.get("trace") or [None])[0]
    if s is None or not obs["calls"]:
        return None
    busy = trace.kernel_seconds(s, KERNELS) / obs["calls"]
    bound, _ = peaks.least_time(obs["local_flops_per_call"],
                                obs["local_bytes_per_call"], obs["dtype"])
    return peaks.share_pct(bound, busy)
