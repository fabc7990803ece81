"""Device time of an iteration's update phase, from the `phase_mark_gae`
kernel's start to the `phase_mark_update` kernel's, as the card ran them in
the traced slice's whole iterations (replays included): the epochs of minibatch steps: gathers, the gradient kernel, clipping and Adam.  The
mean, ms."""

from benchmark.metrics import _program

LAYER = "training loop: ppo/learner.py ReplayedLoop, ppo/population.py, ppo/gae.py"
UNIT = "ms/iteration"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    return _program.phase_ms(record, "update")
