"""expert_roofline: the least time of the held experts over the traced
calls (a layer call at a time, the larger of the operations of the
slots routed to them over the dtype's peak and their bytes, each used
expert's weights read once and the token rows in and out, over the
memory bandwidth: ``drivers/dsv3_serve.py``'s ``Counts``) over the
device time launched inside the program's ``blasx.moe.experts`` spans
(profiler), in percent.  None where the trace holds no such span or no
device time."""
from yardstick import peaks


def read(obs):
    s = (obs.get("trace") or [None])[0]
    names = ((s or {}).get("spans") or {}).get("names", {})
    busy = names.get("blasx.moe.experts", {}).get("device_s", 0.0)
    if "expert_least_s" not in obs:
        return None
    return peaks.share_pct(obs["expert_least_s"], busy)
