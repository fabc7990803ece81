"""Generalized Advantage Estimation (counterpart of `acas2d_tpu/ppo/gae.py:21-44`).

SB3's RolloutBuffer.compute_returns_and_advantage semantics (gamma 0.99,
lambda 0.95): a step with done=True ended its episode, so the next value
does not bootstrap across it.  returns = advantages + values.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_gae(rewards: torch.Tensor, values: torch.Tensor,
                dones: torch.Tensor, last_value: torch.Tensor, gamma: float,
                gae_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major inputs: rewards/values/dones (T, B), last_value (B,).
    Returns (advantages (T, B), returns (T, B))."""
    not_done = 1.0 - dones.to(values.dtype)
    advantages = torch.empty_like(values)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(values.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * not_done[t] - values[t]
        gae = delta + gamma * gae_lambda * not_done[t] * gae
        advantages[t] = gae
        next_value = values[t]
    return advantages, advantages + values
