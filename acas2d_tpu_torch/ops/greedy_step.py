"""The greedy eval's env step: one step of every env under its policy's
clipped mean action, and the bookkeeping of each env's first episode.

`step_plain(carry, mean, params)` is the eager step (`envs/core.step` and
the first episode's return, length, outcome and done flag) over the eval's
carry `(env_state, obs, ret, length, outcome, done_seen)`; the eval's loop
on the CPU and the eager loop on the card run it
(`ppo/learner.greedy_rollout`).  `greedy_step(carry, mean, params)` does the
same step in place on the carry: one launch of the CUDA kernel
(`csrc/greedy_step.cu`) for CUDA tensors, the plain step for CPU tensors.
There is no fallback between the two.  On the card the kernel's carry
equals the eager step's bit for bit, in float32 and float64: it rounds
each operation as torch's one-op CUDA kernels round it, with the
reciprocals of the Python scalars that torch multiplies by in place of a
division (`constants`).  `greedy_step.launches` counts the kernel's
launches; it is not one of the training kernels (`ppo/learner.KERNELS`).
The eval's CUDA graphs (`ppo/learner._ChunkGraphs`) replay one launch a
step after the policy's mean.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from acas2d_tpu_torch.config import EnvParams
from acas2d_tpu_torch.envs import core
from acas2d_tpu_torch.ops import _cuda
from acas2d_tpu_torch.types import EnvState

Carry = Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]

# the kernel's operands, in csrc/greedy_step.cu's order: the env state's
# fields, then the rest of the carry and the mean
OPERANDS = tuple(f.name for f in dataclasses.fields(EnvState)) + (
    "obs", "ret", "length", "first_outcome", "done_seen", "mean")
_FLOAT_CONSTS = (
    "acc", "inv_vdt", "inv_v", "v", "dt", "inv_dt", "inv360", "pi", "two_pi",
    "rad2deg", "inv_max_steps", "goal_x", "goal_y", "inv_d_sep_max",
    "inv_d_cpa_max", "inv_v_closing_max", "inv_d_dev_max", "inv_d_goal_max",
    "inv180", "inv_safe", "inv_d_dev_max_reward", "inv_d_goal_max_reward",
    "coll_dist", "goal_radius", "reward_collision", "reward_goal")
_INT_CONSTS = ("max_steps", "max_traffic", "bug_compat")


class _GreedyConsts(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_double) for k in _FLOAT_CONSTS]
                + [(k, ctypes.c_int) for k in _INT_CONSTS])


def constants(p: EnvParams, dtype: torch.dtype) -> Dict[str, float]:
    """The kernel's constants for an env of `dtype`, as the eager step's
    CUDA ops take them: each Python scalar rounded to `dtype`, and where
    the step divides by a Python scalar, that scalar's reciprocal rounded
    in `dtype` (torch's CUDA division by a CPU scalar is a product with
    it)."""
    t = np.float32 if dtype == torch.float32 else np.float64

    def s(x):
        return float(t(x))

    def inv(x):
        return float(t(1) / t(x))

    return dict(
        acc=s(p.acc_lat_limit), inv_vdt=inv(p.airspeed * p.dt),
        inv_v=inv(p.airspeed), v=s(p.airspeed), dt=s(p.dt), inv_dt=inv(p.dt),
        inv360=inv(360), pi=s(np.pi), two_pi=s(2.0 * np.pi),
        rad2deg=s(180.0 / np.pi), inv_max_steps=inv(p.max_steps),
        goal_x=s(p.goal_x), goal_y=s(p.goal_y),
        inv_d_sep_max=inv(p.d_separation_max), inv_d_cpa_max=inv(p.d_cpa_max),
        inv_v_closing_max=inv(p.v_closing_max),
        inv_d_dev_max=inv(p.d_dev_max), inv_d_goal_max=inv(p.d_goal_max),
        inv180=inv(180), inv_safe=inv(p.safe_distance),
        inv_d_dev_max_reward=inv(p.d_dev_max_reward),
        inv_d_goal_max_reward=inv(p.d_goal_max_reward),
        coll_dist=s(2 * p.collision_radius), goal_radius=s(p.goal_radius),
        reward_collision=s(p.reward_collision), reward_goal=s(p.reward_goal),
        max_steps=int(p.max_steps), max_traffic=int(p.max_traffic),
        bug_compat=int(p.bug_compat))


def step_plain(carry: Carry, mean: torch.Tensor, params: EnvParams
               ) -> Carry:
    """One greedy step of every env, eagerly: the clipped mean action
    (in the mean's dtype, then the env's), `core.step`, and the first
    episode's bookkeeping.  Returns the new carry."""
    env_state, obs, ret, length, outcome, done_seen = carry
    a = torch.clamp(mean, -1.0, 1.0).to(env_state.px.dtype)
    env_state, out = core.step(env_state, a, params)
    active = ~done_seen
    ret = ret + torch.where(active, out.reward, 0.0)
    length = length + active.to(torch.int32)
    outcome = torch.where(active & out.done, out.outcome, outcome)
    done_seen = done_seen | out.done
    return env_state, out.obs, ret, length, outcome, done_seen


def leaves(carry: Carry) -> List[torch.Tensor]:
    """The carry's tensors in OPERANDS' order (the mean left out)."""
    env_state = carry[0]
    return ([getattr(env_state, f.name)
             for f in dataclasses.fields(EnvState)] + list(carry[1:]))


def _operands(carry: Carry, mean: torch.Tensor, params: EnvParams
              ) -> List[torch.Tensor]:
    """The kernel's operands, checked: dtype, shape and contiguity of
    each, then one device for all.  Raises ValueError."""
    ops = leaves(carry) + [mean]
    if len(ops) != len(OPERANDS):
        raise ValueError(f"a carry of {len(ops) - 1} tensors; the greedy "
                         f"step takes {len(OPERANDS) - 1}")
    px = ops[0]
    B, MT = px.shape[0], params.max_traffic
    f, i32 = px.dtype, torch.int32
    if f not in (torch.float32, torch.float64):
        raise ValueError(f"the env must be float32 or float64, got {f}")
    if mean.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"mean must be float32 or float64, got "
                         f"{mean.dtype}")
    want = {"tx": (f, (B, MT)), "ty": (f, (B, MT)), "tv": (f, (B, MT)),
            "tpsi": (f, (B, MT)), "num_traffic": (i32, (B,)),
            "steps": (i32, (B,)), "outcome": (i32, (B,)),
            "obs": (f, (B, params.obs_dim)), "length": (i32, (B,)),
            "first_outcome": (i32, (B,)), "done_seen": (torch.bool, (B,)),
            "mean": (mean.dtype, (B,))}
    for name, t in zip(OPERANDS, ops):
        dtype, shape = want.get(name, (f, (B,)))
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != px.device:
            raise ValueError(f"{name} is on {t.device}, px on {px.device}")
    return ops


@functools.cache
def _kernel() -> Callable:
    """The kernel's entry point; its library is built (alone) and loaded
    at the first launch."""
    _cuda.build(("greedy_step",))
    fn = _cuda.load("greedy_step").acas_greedy_step
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_GreedyConsts), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _greedy_step_cuda(ops: List[torch.Tensor], params: EnvParams) -> None:
    fn = _kernel()
    px, mean = ops[0], ops[-1]
    consts = _GreedyConsts(**constants(params, px.dtype))
    ptrs = (ctypes.c_void_p * len(ops))(*(t.data_ptr() for t in ops))
    rc = fn(ctypes.byref(consts), int(px.dtype == torch.float64),
            int(mean.dtype == torch.float64), px.shape[0],
            ctypes.cast(ptrs, ctypes.c_void_p), _cuda.stream_of(px))
    _cuda.check(rc, _cuda.load("greedy_step"), "greedy_step launch")
    greedy_step.launches += 1


def greedy_step(carry: Carry, mean: torch.Tensor, params: EnvParams
                ) -> None:
    """`step_plain` in place on `carry`: the env state's tensors, obs,
    ret, length, outcome and done_seen are overwritten with the new
    carry's.  `mean` (B,) is the policy's mean action, float32 or float64;
    the env is float32 or float64, with `params.max_traffic` slots.  One
    kernel launch for CUDA tensors, the plain step for CPU tensors."""
    ops = _operands(carry, mean, params)
    if ops[0].is_cuda:
        _greedy_step_cuda(ops, params)
        return
    for dst, src in zip(ops, leaves(step_plain(carry, mean, params))):
        dst.copy_(src)


greedy_step.launches = 0
