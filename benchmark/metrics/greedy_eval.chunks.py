"""Chunks an eval ran before every env had ended (the early exit's work;
at most 16 of 64 and 40 steps at max_steps 1000): the program's
`eval.chunks` counter over the evals (`eval` spans) in the traced slice,
the only stretch in which the program records."""

from benchmark.metrics import _program

LAYER = "greedy eval: ppo/learner.py GreedyEval via population.make_population_eval"
UNIT = "chunks/eval"
SOURCE = "program_counter"
MOVES = "train_env_steps_per_s"


def read(record):
    evals = _program.spans(record, "eval")
    n = _program.counters().get("eval.chunks")
    if evals is None or n is None:
        return None
    return n / len(evals)
