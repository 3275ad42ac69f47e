"""peak_device_gib: torch.cuda.max_memory_allocated() over set-up and
window on the fullest card, in GiB."""


def read(obs):
    if obs["platform"] != "gpu":
        return None
    return obs["peak_bytes"] / 2**30
