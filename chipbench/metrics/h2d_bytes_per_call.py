"""h2d_bytes_per_call: bytes the context's ledger moved host to device
over the window, a call (the scheduler and tile caches: what the cache
did not serve)."""


def read(obs):
    c = obs.get("counters") or {}
    if "h2d_bytes" not in c or not obs["calls"]:
        return None
    return c["h2d_bytes"] / obs["calls"]
