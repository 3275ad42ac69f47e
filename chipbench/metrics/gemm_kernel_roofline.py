"""gemm_kernel_roofline: the call's least time on one card (2MNK over
the dtype's peak, or each operand read once and C written once over the
memory bandwidth, whichever is larger) over the device time of the
port's hand-written GEMM kernels in one call (profiler), in percent."""
import re

from yardstick import peaks, trace

# the kernels of kernels/csrc/blasx_gemm.cu, one a path
KERNELS = re.compile(r"\b(sgemm_kernel|wgmma_gemm_kernel|dmma_gemm_kernel)\b")


def read(obs):
    s = (obs.get("trace") or [None])[0]
    if s is None or not obs["calls"]:
        return None
    busy = trace.kernel_seconds(s, KERNELS) / obs["calls"]
    bound, _ = peaks.least_time(obs["flops_per_call"],
                                obs["bytes_per_call"], obs["dtype"])
    return peaks.share_pct(bound, busy)
