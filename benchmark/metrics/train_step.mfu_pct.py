"""The traced slice's model flop (18,432 for each rollout env-step,
54,016 for each row of each epoch; the evals' forward left out) over the
slice's time at the H100's dense TF32 peak, 495 TFLOP/s, the highest rate
at which it multiplies float32 operands.  The slice holds whole calls
(with their evals, where the cell has them), timed from the sync before
the first to the sync after the last."""

from benchmark import roofline

LAYER = "training step, whole"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_env_steps_per_s"


def read(record):
    tr = record["trace"]
    if tr is None or not tr.work.get("iterations") or not tr.device:
        return None
    w = tr.work
    flop = roofline.train_flop(w["members"], w["n_envs"], w["n_steps"],
                               w["n_epochs"], w["iterations"])
    return 100.0 * flop / (tr.window_s * roofline.MFU_PEAK_FLOP_PER_S)
