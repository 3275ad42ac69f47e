"""launches_per_call: kernel launches the runtime's ledger counted over
the window, a call (taskization and dispatch: batched groups)."""


def read(obs):
    c = obs.get("counters") or {}
    if "kernel_launches" not in c or not obs["calls"]:
        return None
    return c["kernel_launches"] / obs["calls"]
