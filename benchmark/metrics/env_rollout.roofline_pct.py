"""The env-rollout kernel's share of its roofline in the traced slice: the
least time of the launches' work (the env step's operations, a random
action's, the observation's, and a respawn for every episode end counted)
over the kernel's device time."""

from benchmark import roofline

LAYER = "kernel: ops/env_rollout.py, csrc/env_rollout.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "env_steps_per_s"
KERNELS = ("env_rollout_kernel",)


def read(record):
    tr = record["trace"]
    if tr is None or "steps_per_launch" not in tr.work:
        return None
    ev = tr.kernels(*KERNELS)
    if not ev:
        return None
    w = tr.work
    least = roofline.env_rollout_seconds(
        w["n_envs"], w["steps_per_launch"], w["launches"], w["episodes"],
        w["with_obs"])
    return 100.0 * least / (sum(e.dur for e in ev) * 1e-6)
