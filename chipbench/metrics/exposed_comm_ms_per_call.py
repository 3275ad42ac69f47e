"""exposed_comm_ms_per_call: on rank 0, the time in which a collective
(NCCL) kernel runs and no other kernel does, a call (profiler)."""


def read(obs):
    s = (obs.get("trace") or [None])[0]
    if s is None or not obs["calls"]:
        return None
    if not any("nccl" in name.lower() for name in s["kernels"]):
        return None
    return s["exposed_comm_s"] / obs["calls"] * 1e3
