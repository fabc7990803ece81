"""Device time of the autograd update a minibatch step: the update phase
(the `phase_mark_gae` kernel's start to the `phase_mark_update` kernel's,
over the traced slice's whole iterations: the packing, the epochs' gathers
and normalisation, and every step's forward, backward and Adam) over the
program's `update.autograd_steps` counter an iteration, us a step, the
tracer's cost of recording each device op included."""

from benchmark.metrics import _program, _unfused

LAYER = "autograd update: ppo/learner.py ppo_loss_grads, Optimizer.update"
UNIT = "us/step"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    ms = _program.phase_ms(record, "update")
    steps = _unfused.per_iteration(record, "update.autograd_steps")
    if ms is None or steps is None:
        return None
    return ms * 1e3 / steps
