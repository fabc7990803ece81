"""The collectives' share of their roofline on rank 0: the least bytes it
must receive over the slice's collectives ((W - 1) / W of each
all-reduce's buffer and of each all-gather's output, from the program's
byte counters) at NVLink 4's 450 GB/s into an H100 SXM
(`benchmark/roofline_collective.py`), over the union of the NCCL
kernels' device time in the slice's calls."""

from benchmark import roofline_collective
from benchmark.metrics import _collective

LAYER = "collectives: parallel/mesh.py over NCCL"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    tr = record.get("trace")
    world = tr.work.get("world", 1) if tr is not None else 1
    if world < 2:
        return None
    c, us = _collective.counted(record), _collective.device_us(record)
    if c is None or not us:
        return None
    least = roofline_collective.least_seconds(
        world, c["collective.all_reduce.bytes"],
        c["collective.all_gather.bytes"])
    return 100.0 * least / (us * 1e-6)
