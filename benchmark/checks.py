"""The numbers that decide `correct`: what the timed path produced against
the plain reference (`benchmark/reference/`), each held to its limit.

Training (`train` driver): a step is one PPO iteration, of which the
window's call makes K.  For the first three iterations of the training
object that the window then drives, replays of the graph that the window
replays:
  * `loss_gap.<i>`: each iteration's loss (the mean over its minibatch
    steps), the largest gap over the members, as a share of the
    reference's, in a call of K and in calls of one, the wider;
  * `grad_gap`: the first gradient as the optimizer holds it, Adam's first
    moment after iteration 1, leaf by leaf;
  * `update_gap`: the parameters' change over the three iterations, leaf
    by leaf;
  * `state_gap.1`: the envs' positions that the first rollout leaves;
  * `launch_gap`: the launches of the training kernels that the program
    counted in the window (and in the traced slice) against those its
    iterations hold, exact.
A leaf's gap is the gap between the program's norm and the reference's,
as a share of the larger of the reference's norm of that leaf and of the
member's median leaf.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of both (none is, at the
benchmark's configurations: the rule is for a leaf that moves by
round-off alone).
Evals (`attempt`): `eval_gap`, the largest gap over the members of the
mean greedy return, in return units, of the program's eval against the
reference's on the same params and spawns.

Env rollout (`envstep` driver): the rule by which the program's own
tests hold its kernel to its plain version (a copy): `env_flipped`, the
share of envs that flipped a float32 threshold (an episode that ends a
step apart, the goal bearing's 0/360 wrap, the reward's branch), and
`env_err`, the largest error of a state field or sum over the other
envs, as a multiple of its tolerance (ulps a step of the field's
magnitude; a per-step allowance and drift for the sums).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from .reference import ppo as ref

LEAF_FLOOR = 1e-3


def loss_gap(prog: np.ndarray, want: np.ndarray) -> float:
    """Largest |prog - want| / |want| over the members."""
    prog, want = np.asarray(prog, float), np.asarray(want, float)
    return float(np.max(np.abs(prog - want) / np.abs(want)))


def _leaf_norms(x: torch.Tensor) -> torch.Tensor:
    """(P, leaves) norms of (P, N_PARAMS)."""
    return torch.stack([v.reshape(v.shape[0], -1).to(torch.float64)
                        .norm(dim=-1)
                        for v in ref.leaves(x).values()], dim=-1)


def leaf_gaps(prog: torch.Tensor, want: torch.Tensor,
              ref_grad: torch.Tensor) -> torch.Tensor:
    """(P, leaves) gaps of leaf norms (see above); 0 for a leaf left out."""
    got, exp = _leaf_norms(prog.cpu()), _leaf_norms(want.cpu())
    g = _leaf_norms(ref_grad.cpu())
    keep = g >= LEAF_FLOOR * g.median(dim=-1, keepdim=True).values
    scale = torch.maximum(exp, exp.median(dim=-1, keepdim=True).values)
    return torch.where(keep, (got - exp).abs() / scale, 0.0)


def leaf_gap(prog: torch.Tensor, want: torch.Tensor,
             ref_grad: torch.Tensor) -> float:
    """Largest gap of leaf norms over members and leaves."""
    return float(leaf_gaps(prog, want, ref_grad).max())


def median_leaf_gap(prog: torch.Tensor, want: torch.Tensor,
                    ref_grad: torch.Tensor) -> float:
    """Largest over the members of the median leaf's gap."""
    return float(leaf_gaps(prog, want, ref_grad).median(dim=-1).values.max())


def state_gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    """The 99th percentile over the envs of |dx| + |dy| (px) between two
    (2, envs) position arrays: the state the first rollout leaves, robust
    to the few envs that part on a float32 threshold."""
    gap = (prog.double().cpu() - want.double().cpu()).abs().sum(0)
    return float(torch.quantile(gap, 0.99))


def eval_gap(prog: Dict[str, np.ndarray], want: Dict[str, torch.Tensor]
             ) -> float:
    return float(np.max(np.abs(
        np.asarray(prog["eval_return_mean"], float).reshape(-1)
        - want["eval_return_mean"].double().cpu().numpy().reshape(-1))))


# -------------------------------------------------- env rollout agreement

ULPS_PER_STEP, SUM_ATOL_PER_STEP, SUM_DRIFT = 2, 5e-5, 5e-7
FLOATS = ("px", "py", "psi", "tx", "ty", "tv", "tpsi", "total",
          "reward_sum", "obs_sum")
INTS = ("steps", "episodes", "goals", "collisions")
SUMS = ("total", "reward_sum", "obs_sum")
REWARDS = ("total", "reward_sum")


def _tol(key: str, want: torch.Tensor, T: int) -> float:
    if key in SUMS:
        return T * SUM_ATOL_PER_STEP + T * T * SUM_DRIFT
    top = max(float(want.abs().max()), 1e-30)
    return T * ULPS_PER_STEP * 2.0 ** (math.floor(math.log2(top)) - 23)


def env_agreement(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                  T: int) -> Tuple[float, float]:
    """(share of envs flipped, largest error over the other envs as a
    multiple of its tolerance) of the program's outputs `got` against the
    reference's `want` (same keys)."""
    want = {k: v.float() if k in FLOATS else v for k, v in want.items()}
    got = {k: v.to(want[k].device) for k, v in got.items()}
    flipped = torch.zeros_like(want["steps"], dtype=torch.bool)
    for k in INTS:
        flipped |= got[k] != want[k]
    tol_obs = _tol("obs_sum", want["obs_sum"], T)
    d_obs = (got["obs_sum"] - want["obs_sum"]).abs()
    flipped |= (d_obs > tol_obs) & ((d_obs - d_obs.round()).abs() <= tol_obs)
    tol_r = _tol("reward_sum", want["reward_sum"], T)
    d_r = (got["reward_sum"] - want["reward_sum"]).abs()
    branch = (d_r > tol_r) & (d_r <= 1.0 + tol_r) & ~flipped
    worst = 0.0
    for k in FLOATS:
        keep = ~(flipped | branch) if k in REWARDS else ~flipped
        g, w = got[k][keep], want[k][keep]
        if not w.numel():
            continue
        d = (g - w).abs()
        tol = _tol(k, w, T)
        if k == "psi":
            near = torch.minimum(w, 360.0 - w) <= tol
            d = torch.where(near, torch.minimum(d, 360.0 - d), d)
        worst = max(worst, float(d.max()) / tol)
    if not bool(torch.isfinite(torch.tensor(worst))):
        worst = float("inf")
    share = float((flipped | branch).sum()) / flipped.numel()
    return share, worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Tuple[float, float]]]:
    """Each number that the cell's limits name against its limit; a NaN,
    or a limit whose number is missing, fails."""
    out, ok = {}, bool(limits)
    for k in sorted(limits):
        v, lim = numbers.get(k, float("nan")), limits[k]
        out[k] = (v, lim)
        ok = ok and bool(v <= lim)
    return ok, out
