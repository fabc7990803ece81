"""The card's time in an eval, per eval: the union of the device's
operations over the `eval` spans (the chunks' replays, the copies in and
the result's reduction).  The tracer slows the host down at every launch
but not the device's operations, so this reads as the untraced eval's
device time: against `greedy_eval.ms`, the untraced eval's wall, it says
how much of an eval the card waits on the host."""

from benchmark.metrics import _program

LAYER = "greedy eval: ppo/learner.py GreedyEval via population.make_population_eval"
UNIT = "ms/eval"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    evals = _program.spans(record, "eval")
    tr = record["trace"]
    if evals is None or not tr.device:
        return None
    return _program.busy(tr, [(e.start, e.end) for e in evals]) * 1e-3 \
        / len(evals)
