"""Batch-native state containers of the PyTorch ACAS-2D engine.

Counterpart of `acas2d_tpu/types.py`.  The JAX package keeps one env's state
per pytree and adds the batch axis with `vmap`; here every field carries the
batch axis itself: `(B,)` for player and bookkeeping fields and
`(B, max_traffic)` for traffic fields.  There is no per-env PRNG key: spawns
draw from an explicit `torch.Generator` passed to `envs.core`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EnvState:
    """Per-env simulation state, struct of arrays over the batch."""

    # Player aircraft (game.py:84-92); its airspeed is params.airspeed.
    px: torch.Tensor          # (B,) x position [px]
    py: torch.Tensor          # (B,) y position [px]
    ppsi: torch.Tensor        # (B,) heading [deg, 0..360), clockwise from +x
    pa_lat: torch.Tensor      # (B,) last commanded lateral acceleration

    # Traffic aircraft (game.py:95-115), (B, max_traffic) each.
    tx: torch.Tensor
    ty: torch.Tensor
    tv: torch.Tensor
    tpsi: torch.Tensor

    num_traffic: torch.Tensor   # (B,) int32; slots >= num_traffic are inert

    # Episode bookkeeping (game.py:29-41).
    steps: torch.Tensor         # (B,) int32; incremented by observe
    total_reward: torch.Tensor  # (B,)
    outcome: torch.Tensor       # (B,) int32; 0 running / 1 goal / 2 collision / 3 timeout

    @property
    def done(self) -> torch.Tensor:
        return self.outcome != 0

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    def select(self, mask: torch.Tensor, other: "EnvState") -> "EnvState":
        """Per env: this state where `mask` (B,) holds, else `other`."""
        def pick(a, b):
            m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)
        return EnvState(**{f.name: pick(getattr(self, f.name),
                                        getattr(other, f.name))
                           for f in dataclasses.fields(self)})


@dataclasses.dataclass
class StepOutput:
    """One transition's outputs over the batch."""
    obs: torch.Tensor             # (B, obs_dim)
    reward: torch.Tensor          # (B,)
    done: torch.Tensor            # (B,) bool
    outcome: torch.Tensor         # (B,) outcome of the terminated episode (0 if not done)
    episode_steps: torch.Tensor   # (B,) step counter at termination (0 if not done)
    episode_return: torch.Tensor  # (B,) total reward at termination (0 if not done)

    def replace(self, **changes) -> "StepOutput":
        return dataclasses.replace(self, **changes)
