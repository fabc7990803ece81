"""Device operations (kernels, copies, sets; the phase marks left out)
started in the unfused rollout's phase, between the `phase_mark_start`
and `phase_mark_rollout` kernels' starts, over the traced slice's whole
iterations, per batched env step (the program's `rollout.env_steps`
counter an iteration)."""

import bisect

from benchmark.metrics import _program, _unfused

LAYER = "unfused rollout: ppo/learner.py rollout_members, envs/core.py step_autoreset"
UNIT = "kernels/env-step"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    its = _program.iterations(record)
    steps = _unfused.per_iteration(record, "rollout.env_steps")
    if its is None or steps is None:
        return None
    starts = sorted(e.start for e in record["trace"].device
                    if _program.MARK not in e.name)
    n = sum(bisect.bisect_left(starts, it[1])
            - bisect.bisect_left(starts, it[0]) for it in its)
    return n / (len(its) * steps)
