"""Env-steps of the window's env-rollout launches (B x T each) per second
of the window."""

LAYER = "end to end"
UNIT = "env-steps/s"
SOURCE = "host_clock"
MOVES = None


def read(record):
    work = record["work"]
    if "launches" not in work:
        return None
    return work["env_steps"] / record["window_s"]
