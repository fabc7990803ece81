"""Seconds from the process's start to the window's: imports, loading (and
in a new checkout building) the kernels, the inputs and the program's state
from the seed, the capture of the training graph and the eval's graphs,
and the warm calls of this cell's shapes."""

LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"
MOVES = None


def read(record):
    return record["setup_s"]
