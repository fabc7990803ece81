"""The policy-rollout kernel's share of its roofline in the traced slice:
the least time of the launches' work (the policy's products, its other
operations and the env step's, with a respawn for every episode end the
iterations' metrics report) over the kernel's device time."""

from benchmark import roofline

LAYER = "kernel: ops/policy_rollout.py, csrc/policy_rollout.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"
KERNELS = ("policy_rollout_kernel",)


def read(record):
    tr = record["trace"]
    if tr is None or "launches_rollout" not in tr.work:
        return None
    ev = tr.kernels(*KERNELS)
    if not ev:
        return None
    w = tr.work
    least = roofline.policy_rollout_seconds(
        w["members"], w["n_envs"], w["chunk"], w["launches_rollout"],
        w["episodes"])
    return 100.0 * least / (sum(e.dur for e in ev) * 1e-6)
