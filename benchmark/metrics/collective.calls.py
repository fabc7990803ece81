"""Collectives per iteration on rank 0: the program's all-reduce and
all-gather counters over the traced slice (eager calls, and at each replay
of a captured iteration the collectives its graph holds), over the slice's
iterations."""

from benchmark.metrics import _collective

LAYER = "collectives: parallel/mesh.py over NCCL"
UNIT = "calls/iteration"
SOURCE = "program_counter"
MOVES = "train_env_steps_per_s"


def read(record):
    c = _collective.counted(record)
    n = record["trace"].work.get("iterations") if c is not None else None
    if not n:
        return None
    return (c["collective.all_reduce"] + c["collective.all_gather"]) / n
