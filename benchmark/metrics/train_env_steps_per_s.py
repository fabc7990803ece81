"""Env-steps that the window's PPO iterations collected, over all members,
per second of the window (evals, where the mix has them, inside it)."""

LAYER = "end to end"
UNIT = "env-steps/s"
SOURCE = "host_clock"
MOVES = None


def read(record):
    work = record["work"]
    if "iterations" not in work:
        return None
    return work["env_steps"] / record["window_s"]
