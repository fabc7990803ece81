"""The share of the traced slice of a training cell in which no operation
ran on the card."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"


def read(record):
    tr = record["trace"]
    if tr is None or "iterations" not in tr.work or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
