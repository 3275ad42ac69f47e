"""copy_ms_per_call: device time of the host-to-device and
device-to-host copies in the traced window, a call (profiler)."""


def read(obs):
    s = (obs.get("trace") or [None])[0]
    if s is None or s["busy_s"] <= 0 or not obs["calls"]:
        return None
    copy = s["copy_s"].get("HtoD", 0.0) + s["copy_s"].get("DtoH", 0.0)
    return copy / obs["calls"] * 1e3
