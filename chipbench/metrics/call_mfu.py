"""call_mfu: the useful operations of the traced window over the window
times the dtype's peak times the cards, in percent."""
from yardstick import peaks


def read(obs):
    if obs["platform"] != "gpu" or not obs["calls"] or obs["window_s"] <= 0:
        return None
    peak = peaks.PEAK_FLOPS[obs["dtype"]] * obs["chips"]
    return 100.0 * obs["flops_per_call"] * obs["calls"] / (
        obs["window_s"] * peak)
