"""Device time of the training calls' other operations (GAE, gathers,
Adam, normalisation, copies: everything the gradient and rollout kernels'
metrics do not name) per traced iteration."""

LAYER = "training loop: ppo/learner.py ReplayedLoop, ppo/population.py, ppo/gae.py"
UNIT = "ms/iteration"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"
NAMED = ("grad_partials", "grad_reduce_kernel", "policy_rollout_kernel")


def read(record):
    tr = record["trace"]
    if tr is None or not tr.work.get("iterations"):
        return None
    ev = [e for e in tr.kernels(within=("bench.call", "bench.readback"))
          if not any(n in e.name for n in NAMED)]
    if not ev:
        return None
    return sum(e.dur for e in ev) * 1e-3 / tr.work["iterations"]
