"""tflops: the useful operations of every call in the window over the
window's whole elapsed time (on several cards, all ranks' work over rank
0's window)."""


def read(obs):
    if not obs["calls"] or obs["window_s"] <= 0:
        return None
    return obs["flops_per_call"] * obs["calls"] / obs["window_s"] / 1e12
