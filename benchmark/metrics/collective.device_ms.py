"""Rank 0's NCCL time per iteration: the union of the NCCL kernels' device
time (kernels whose name holds `nccl`) inside the traced slice's calls,
over the slice's iterations.  A collective's kernel runs from its launch
until the last rank's data has arrived, so this holds the waits on the
other ranks as well as the transfers."""

from benchmark.metrics import _collective

LAYER = "collectives: parallel/mesh.py over NCCL"
UNIT = "ms/iteration"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    us = _collective.device_us(record)
    n = record["trace"].work.get("iterations") if us is not None else None
    if not n:
        return None
    return us * 1e-3 / n
