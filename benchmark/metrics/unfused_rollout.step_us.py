"""Device time of the unfused rollout a batched env step: the rollout
phase (the `phase_mark_start` kernel's start to the `phase_mark_rollout`
kernel's, over the traced slice's whole iterations) over the program's
`rollout.env_steps` counter an iteration.  The policy's forward, the
Gaussian sample and the engine's `step_autoreset`, one-op kernels each, us
a step.  The tracer's record of each of the iteration's ~1 M device ops
stretches the traced phase (~1.8x the untraced iteration on an H100), so
a change to the rollout's work shows in `unfused_rollout.kernels_per_step`
and the end-to-end rate more truly than here."""

from benchmark.metrics import _program, _unfused

LAYER = "unfused rollout: ppo/learner.py rollout_members, envs/core.py step_autoreset"
UNIT = "us/env-step"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    ms = _program.phase_ms(record, "rollout")
    steps = _unfused.per_iteration(record, "rollout.env_steps")
    if ms is None or steps is None:
        return None
    return ms * 1e3 / steps
