"""Episode spawns from the reference's Mersenne stream (exact-protocol eval).

A copy of `MersenneSpawner` and `EpisodeInit` from `acas2d_tpu/oracle.py`
(:189-270), which the port cannot import (the JAX package's `__init__`
imports jax).  The rest of that module, the scalar oracle environment, stays
a test fixture of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional

import numpy as np

from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams

TWO_PI = 2 * math.pi


def relative_angle(x1: float, y1: float, x2: float, y2: float) -> float:
    """Bearing from (x1,y1) to (x2,y2) in degrees in [0,360)
    (kinematics.py:16-22)."""
    return math.degrees(math.atan2(y2 - y1, x2 - x1) % TWO_PI)


@dataclasses.dataclass
class EpisodeInit:
    """Initial conditions of one episode, as drawn by the reference RNG."""
    num_traffic: int
    player_psi: float                    # degrees in [0, 360)
    traffic_x: np.ndarray                # (max_traffic,) float64
    traffic_y: np.ndarray
    traffic_v: np.ndarray
    traffic_psi: np.ndarray


class MersenneSpawner:
    """Replays the reference's episode-spawn RNG stream exactly.

    The reference seeds the global `random` module once per process and
    every `ACAS2DGame.__init__` draws from that stream in a fixed order
    (game.py:41,88,91-92,98-114):

      1. randint(MIN_TRAFFIC, MAX_TRAFFIC)        -> num_traffic
      2. uniform(0, 360)                          -> drawn then overwritten
      3. uniform(-lim, +lim)                      -> player heading jitter
      4. per traffic aircraft n:
           n == 0: randint(0,1) starts_down; uniform(f_min,f_max) speed
                   factor; uniform(-15,15) heading jitter
           n  > 0: uniform(0, W-size) x; uniform(0, 3H/5) y;
                   uniform(f_min,f_max); uniform(0,360) heading

    A private `random.Random(seed)` reproduces CPython's own draws.
    `skip_episodes` accounts for env constructions before the first measured
    episode (baseline_main.py:19-22 constructs two).
    """

    def __init__(self, params: EnvParams = DEFAULT_PARAMS,
                 seed: Optional[int] = None, skip_episodes: int = 0):
        self.p = params
        self.rng = random.Random(params.seed if seed is None else seed)
        for _ in range(skip_episodes):
            self.spawn()

    def spawn(self) -> EpisodeInit:
        p = self.p
        rng = self.rng
        num_traffic = rng.randint(p.min_traffic, p.max_traffic)   # game.py:41
        rng.uniform(0, 360)                                       # game.py:88 (discarded)
        bearing = relative_angle(p.player_x0, p.player_y0, p.goal_x, p.goal_y)
        player_psi = (bearing + rng.uniform(-p.player_initial_heading_lim,
                                            p.player_initial_heading_lim)) % 360
        tx = np.zeros(p.max_traffic)
        ty = np.zeros(p.max_traffic)
        tv = np.full(p.max_traffic, p.airspeed)
        tpsi = np.zeros(p.max_traffic)
        for n in range(num_traffic):
            if n == 0:                                            # game.py:98-106
                starts_down = rng.randint(0, 1)
                tx[n] = p.width - p.collision_radius
                ty[n] = p.collision_radius + starts_down * (
                    p.height - 2 * p.collision_radius)
                tv[n] = rng.uniform(p.airspeed_factor_min,
                                    p.airspeed_factor_max) * p.airspeed
                tpsi[n] = (145 + starts_down * 70 +
                           rng.uniform(-p.traffic_initial_heading_lim,
                                       p.traffic_initial_heading_lim)) % 360
            else:                                                 # game.py:107-114
                tx[n] = rng.uniform(0, p.width - p.aircraft_size)
                ty[n] = rng.uniform(0, 3 * p.height / 5)
                tv[n] = rng.uniform(p.airspeed_factor_min,
                                    p.airspeed_factor_max) * p.airspeed
                tpsi[n] = rng.uniform(0, 360)
        return EpisodeInit(num_traffic=num_traffic, player_psi=player_psi,
                           traffic_x=tx, traffic_y=ty,
                           traffic_v=tv, traffic_psi=tpsi)

    def spawn_batch(self, n: int) -> List[EpisodeInit]:
        return [self.spawn() for _ in range(n)]
