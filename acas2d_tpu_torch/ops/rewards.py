"""Branchless shaped-reward ops of the ACAS-2D engine (torch).

Counterpart of `acas2d_tpu/ops/rewards.py:22-78`: the reference's branches
(`gym_ACAS2D/envs/rewards.py`) become `torch.where` selects.  Integer powers
are written as products, as XLA lowers them.
"""

from __future__ import annotations

import torch

from acas2d_tpu_torch.ops.kinematics import delta_heading


def _pow4(x):
    sq = x * x
    return sq * sq


def heading_reward(psi, phi):
    """(1 - delta_heading/180)^4 (rewards.py:5-9)."""
    return _pow4(1 - delta_heading(psi, phi) / 180)


def closest_approach_reward(v_closing, d_cpa, safe_distance):
    """1 when separating, else min(1, (d_cpa/SAFE_DISTANCE)^4)
    (rewards.py:12-16)."""
    capped = torch.clamp(_pow4(d_cpa / safe_distance), max=1.0)
    return torch.where(v_closing > 0, 1.0, capped)


def plan_deviation_reward(d_dev, d_dev_max):
    """(1 - |d_dev|/d_dev_max)^0.5 inside the band, 0 outside
    (rewards.py:19-27); the base is clamped at 0 so the masked branch never
    produces NaN."""
    frac = torch.abs(d_dev) / d_dev_max
    inside = torch.sqrt(torch.clamp(1 - frac, min=0.0))
    return torch.where(frac > 1.0, 0.0, inside)


def goal_distance_reward(d_goal, d_goal_max):
    """min(1, (1 - d_goal/d_goal_max)^4) (rewards.py:44-50)."""
    return torch.clamp(_pow4(1 - d_goal / d_goal_max), max=1.0)


def step_reward(v_closing, psi, phi, d_cpa, d_goal, d_dev,
                safe_distance, d_dev_max_reward, d_goal_max_reward):
    """step_reward_5 (rewards.py:53-60): heading * (cpa * deviation) while
    approaching (v_closing <= 0), heading * goal-distance otherwise."""
    h = heading_reward(psi, phi)
    approach = (closest_approach_reward(v_closing, d_cpa, safe_distance)
                * plan_deviation_reward(d_dev, d_dev_max_reward))
    separating = goal_distance_reward(d_goal, d_goal_max_reward)
    return h * torch.where(v_closing <= 0, approach, separating)


def polarized_plan_deviation_reward(d_dev, d_cpa, d_dev_max):
    """rewards.py:30-41 — the display-only variant (game.py:421-428)."""
    frac = torch.abs(d_dev) / d_dev_max
    inside = torch.sqrt(torch.clamp(1 - frac, min=0.0))
    zero = (frac > 1.0) | ((d_cpa * d_dev) < 0)
    return torch.where(zero, 0.0, inside)


def step_reward_6(v_closing, psi, phi, d_cpa, d_goal, d_dev,
                  safe_distance, d_dev_max_reward, d_goal_max_reward):
    """rewards.py:63-70 — the HUD-display reward variant."""
    h = heading_reward(psi, phi)
    approach = (closest_approach_reward(v_closing, d_cpa, safe_distance)
                * polarized_plan_deviation_reward(d_dev, d_cpa,
                                                  d_dev_max_reward))
    separating = goal_distance_reward(d_goal, d_goal_max_reward)
    return h * torch.where(v_closing <= 0, approach, separating)
