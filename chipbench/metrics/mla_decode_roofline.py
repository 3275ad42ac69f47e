"""mla_decode_roofline: the least time of MLA's absorbed decode over the
traced calls (a layer and a step at a time, the larger of its operations
at each slot's live context over the dtype's peak and its bytes, the
live latent cache, W_uk and W_uv, q and the output, over the memory
bandwidth: ``drivers/dsv3_serve.py``'s ``Counts``) over the device time
launched inside the program's ``blasx.mla.decode`` spans (profiler), in
percent.  None where the trace holds no such span or no device time."""
from yardstick import peaks


def read(obs):
    s = (obs.get("trace") or [None])[0]
    names = ((s or {}).get("spans") or {}).get("names", {})
    busy = names.get("blasx.mla.decode", {}).get("device_s", 0.0)
    if "mla_decode_least_s" not in obs:
        return None
    return peaks.share_pct(obs["mla_decode_least_s"], busy)
