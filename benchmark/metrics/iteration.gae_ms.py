"""Device time of an iteration's gae phase, from the `phase_mark_rollout`
kernel's start to the `phase_mark_gae` kernel's, as the card ran them in
the traced slice's whole iterations (replays included): GAE (ppo/gae.py), its loop of small operations.  The
mean, ms."""

from benchmark.metrics import _program

LAYER = "training loop: ppo/learner.py ReplayedLoop, ppo/population.py, ppo/gae.py"
UNIT = "ms/iteration"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    return _program.phase_ms(record, "gae")
