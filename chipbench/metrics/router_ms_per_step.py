"""router_ms_per_step: the device time launched inside the program's
``blasx.moe.route`` spans (profiler) over the traced calls, a decode
step each, in ms a step.  None where the trace holds no such span or no
device time."""


def read(obs):
    s = (obs.get("trace") or [None])[0]
    names = ((s or {}).get("spans") or {}).get("names", {})
    busy = names.get("blasx.moe.route", {}).get("device_s", 0.0)
    if busy <= 0 or not obs["calls"]:
        return None
    return busy / obs["calls"] * 1e3
