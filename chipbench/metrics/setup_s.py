"""setup_s: from the start of the run's process to the start of the
first timed call (import, library load or build, operands from the
seed, tiling, warm-up; on several cards the ranks' start and the
process group too)."""


def read(obs):
    return obs["setup_s"]
