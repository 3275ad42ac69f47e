"""latency_p95_ms: the nearest-rank 95th percentile of every call's wall
time in the window (host clock, each call ending in a synchronise)."""
from yardstick.window import nearest_rank


def read(obs):
    if not obs["latencies_s"]:
        return None
    return nearest_rank(obs["latencies_s"], 95) * 1e3
