"""The yardstick's arithmetic: published peaks of one H100 and the least
time of each kernel's work, counted from the shapes and frozen here.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W power limit):
memory 3.35 TB/s; float32 on the CUDA cores 67 TFLOP/s (an FMA counted
as 2); bf16 989 and TF32 495 TFLOP/s on the tensor cores.  The
special-function units (a sine, cosine, square root or division counted
as one op) and the 32-bit integer units give 16 and 64 results a clock
an SM against the float32 units' 128 (CUDA C++ Programming Guide,
compute capability 9.0), so their peaks are 16/256 and 64/256 of the
float32 rate.  A least time is the larger of the bytes' time (each input
read once, each output written once) and the busiest unit's time; where
a product can run on the CUDA cores in float32 or on the tensor cores as
3xTF32 (three TF32 products for one float32 one), the faster route
bounds.
"""

from __future__ import annotations

from typing import Dict

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12,
                  "sfu": 67e12 * 16 / 256, "int": 67e12 * 64 / 256}
# the highest rate at which the card multiplies float32 operands: dense
# TF32 on the tensor cores; no float32 path can pass it
MFU_PEAK_FLOP_PER_S = PEAK_OPS_PER_S["tf32"]

HIDDEN, OBS_DIM, N_PARAMS = 64, 8, 9603
# the policy's products an env-step: both towers' two layers, 2 flop a MAC
ROLLOUT_STEP_FLOP = 2 * 2 * (HIDDEN * OBS_DIM + HIDDEN * HIDDEN)
# a row of a gradient step: the forward, 2 x 4,672 MACs, and the backward,
# 2 x 8,832 MACs, of the two towers
GRAD_ROW_FLOP = 2 * (2 * 4672 + 2 * 8832)
# the policy's other operations an env-step: biases, heads, the Gaussian
# sample (f32), and the 256 tanh and the sample's log, root, cosine and
# divide (special-function)
POLICY_STEP_OPS = {"f32": 2 * (2 * HIDDEN + 2 * HIDDEN + 1) + 11,
                   "sfu": 2 * 2 * HIDDEN + 4}
# the env's operations (csrc/env_rollout.cu's semantics): every env-step;
# a random action; the observation's eight features and their sum; an
# episode's end (the respawn); and with the observation, an end's new
# heading pair and geometry
ENV_STEP_OPS = {"f32": 221, "sfu": 19, "int": 9}
ENV_ACTION_OPS = {"f32": 3, "int": 14}
ENV_OBS_OPS = {"f32": 18}
ENV_RESPAWN_OPS = {"f32": 29, "sfu": 2, "int": 42}
ENV_OBS_RESPAWN_OPS = {"f32": 159, "sfu": 18}


def least_seconds(n_bytes: float, ops: Dict[str, float]) -> float:
    """The least time of work that moves n_bytes and does `ops` ({unit:
    count}) at the peaks."""
    return max([n_bytes / PEAK_BYTES_PER_S]
               + [n / PEAK_OPS_PER_S[u] for u, n in ops.items()])


def _add(a: Dict[str, float], b: Dict[str, float], k: float = 1.0):
    for u, n in b.items():
        a[u] = a.get(u, 0.0) + k * n
    return a


def env_ops(steps: float, episodes: float, with_obs: bool,
            random_actions: bool = True) -> Dict[str, float]:
    """The env's operations over `steps` env-steps with `episodes` ends."""
    ops = _add({}, ENV_STEP_OPS, steps)
    _add(ops, ENV_ACTION_OPS, steps if random_actions else 0)
    _add(ops, ENV_OBS_OPS, steps if with_obs else 0)
    _add(ops, ENV_RESPAWN_OPS, episodes)
    _add(ops, ENV_OBS_RESPAWN_OPS, episodes if with_obs else 0)
    return ops


def env_rollout_seconds(B: int, T: int, launches: int, episodes: float,
                        with_obs: bool = True) -> float:
    """Least time of `launches` env-rollout launches of B envs x T steps
    with `episodes` ends among them: nine arrays in, fourteen out a launch."""
    n_bytes = 4 * B * (9 + 14) * launches
    return least_seconds(n_bytes, env_ops(B * T * launches, episodes,
                                          with_obs))


def policy_rollout_seconds(P: int, B: int, K: int, launches: int,
                           episodes: float) -> float:
    """Least time of `launches` policy-rollout launches of P members x B
    envs x K steps with `episodes` ends among them."""
    PB = P * B
    n_bytes = 4 * launches * (8 * PB + PB + 8 * PB + P * N_PARAMS
                              + 9 * PB + PB + 8 * PB + K * PB * 8
                              + 6 * K * PB + 2 * K * PB)
    steps = K * PB * launches
    ops = _add(env_ops(steps, episodes, True), POLICY_STEP_OPS, steps)
    products = steps * ROLLOUT_STEP_FLOP
    cores = least_seconds(n_bytes, {**ops, "f32": ops["f32"] + products})
    tensor = least_seconds(n_bytes, {**ops, "tf32": 3 * products})
    return min(cores, tensor)


def grads_seconds(P: int, n: int, launches: int) -> float:
    """Least time of `launches` float32 gradient launches of P members x n
    rows."""
    n_bytes = 4 * launches * (P * n * 13 + 2 * P * N_PARAMS + 4 * P)
    flop = launches * P * n * GRAD_ROW_FLOP
    return min(least_seconds(n_bytes, {"f32": flop}),
               least_seconds(n_bytes, {"tf32": 3 * flop}))


def train_flop(P: int, n_envs: int, n_steps: int, n_epochs: int,
               iterations: int) -> float:
    """The model flop of `iterations` PPO iterations: the policy's products
    for every rollout env-step and the gradient's for every row of every
    epoch (the eval's forward, ~0.05% of an attempt's, left out)."""
    rows = P * n_envs * n_steps * iterations
    return rows * ROLLOUT_STEP_FLOP + rows * n_epochs * GRAD_ROW_FLOP
