"""Batched environment API (counterpart of `acas2d_tpu/envs/vector.py:27-46`).

The JAX package builds its batch with `vmap` over the single-env core; the
port's core is batch-native already, so these are the same calls under the
names the learner and drivers use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams
from acas2d_tpu_torch.envs import core
from acas2d_tpu_torch.types import EnvState, StepOutput


def reset_batch(n_envs: int, params: EnvParams = DEFAULT_PARAMS,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device=None
                ) -> Tuple[EnvState, torch.Tensor]:
    """Spawn n_envs independent envs: (states (B,)-batched, obs (B, O)) on
    `device` (default CUDA; raises without it unless given the CPU)."""
    return core.reset(n_envs, params, generator, dtype, device)


def step_batch(states: EnvState, actions: torch.Tensor,
               params: EnvParams = DEFAULT_PARAMS
               ) -> Tuple[EnvState, StepOutput]:
    """`core.step` over the batch: actions (B,)."""
    return core.step(states, actions, params)


def step_autoreset_batch(states: EnvState, actions: torch.Tensor,
                         params: EnvParams = DEFAULT_PARAMS,
                         generator: Optional[torch.Generator] = None,
                         fresh: Optional[Tuple[EnvState, torch.Tensor]] = None
                         ) -> Tuple[EnvState, StepOutput]:
    """`core.step_autoreset` over the batch: actions (B,); terminated envs
    respawn as `fresh` (a reset batch made beforehand), else with draws
    from `generator` (on the batch's device for speed)."""
    return core.step_autoreset(states, actions, params, generator, fresh)
