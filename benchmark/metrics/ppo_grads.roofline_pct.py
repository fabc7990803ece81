"""The gradient kernel's share of its roofline in the traced slice: the
least time of the launches' work (54,016 flop and 13 floats a row, for
every row of every epoch; the faster of float32 CUDA cores and 3xTF32 at
the published peaks) over the device time of its two passes."""

from benchmark import roofline

LAYER = "kernel: ops/ppo_grads.py, csrc/ppo_grads.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_env_steps_per_s"
KERNELS = ("grad_partials_tf32x3", "grad_reduce_kernel")


def read(record):
    tr = record["trace"]
    if tr is None or "launches_grads" not in tr.work:
        return None
    ev = tr.kernels(*KERNELS)
    if not ev:
        return None
    w = tr.work
    least = roofline.grads_seconds(w["members"], w["minibatch"],
                                   w["launches_grads"])
    return 100.0 * least / (sum(e.dur for e in ev) * 1e-6)
