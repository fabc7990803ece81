"""Host time of an eval outside its chunks, per eval: the `eval` span's
time less its `eval.chunk` children's, which leaves the spawn
(`eval.reset`), the capture of a new shape, the copies in (`eval.load`)
and the result (`eval.result`: its copies and its reduction)."""

from benchmark.metrics import _program

LAYER = "greedy eval: ppo/learner.py GreedyEval via population.make_population_eval"
UNIT = "ms/eval"
SOURCE = "program_span"
MOVES = "train_env_steps_per_s"


def read(record):
    evals = _program.spans(record, "eval")
    if evals is None:
        return None
    ids = {e.id for e in evals}
    chunks = [c for c in _program.spans(record, "eval.chunk") or ()
              if c.parent in ids]
    return (sum(e.dur for e in evals) - sum(c.dur for c in chunks)) \
        * 1e-3 / len(evals)
