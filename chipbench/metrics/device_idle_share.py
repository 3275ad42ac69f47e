"""device_idle_share: the share of the traced window in which no kernel
and no copy runs on the card (profiler), the mean over the cards, in
percent."""


def read(obs):
    rows = [s for s in (obs.get("trace") or []) if s is not None]
    if not rows or not any(s["busy_s"] > 0 for s in rows):
        return None
    return 100.0 * sum(1 - s["busy_s"] / s["window_s"] for s in rows) / len(
        rows)
