"""p2p_hops_per_call: ring hops (one send and one receive a rank) rank 0
issued over the window, a call, by the port's collective counters."""


def read(obs):
    c = obs.get("counters") or {}
    if "p2p" not in c or not obs["calls"]:
        return None
    return c["p2p"] / obs["calls"]
