"""Host clock around each of the window's evals, which ends in its
read-back, with the bookkeeping that follows it (the population tracker's
update), as the training driver's eval_seconds is: the mean, ms."""

LAYER = "greedy eval: ppo/learner.py GreedyEval via population.make_population_eval"
UNIT = "ms/eval"
SOURCE = "host_clock"
MOVES = "train_env_steps_per_s"


def read(record):
    ev = record["eval_s"]
    if not ev:
        return None
    return 1e3 * sum(ev) / len(ev)
