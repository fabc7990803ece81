"""Environment parameters of the PyTorch ACAS-2D engine.

A copy of `acas2d_tpu/config.py` (the port imports nothing of the JAX
package): every tunable of the reference constants module
(`gym_ACAS2D/settings.py:1-54`) as a frozen dataclass passed explicitly into
the step/reset functions.  Defaults reproduce the reference environment.

  * `EnvParams` holds Python scalars only; the kernels receive its derived
    constants as float32 values computed here in float64.
  * Derived normalizers (`d_goal_max`, ...) are episode-invariant in the
    reference (the player spawn is deterministic,
    `gym_ACAS2D/envs/game.py:84-92,118-128`), so they are computed once here
    rather than stored per env.
"""

from __future__ import annotations

import dataclasses
import math

# Standard gravity [m/s^2], by definition (equals scipy.constants.g used at
# settings.py:1,42).
STANDARD_GRAVITY = 9.80665

# Outcome codes (settings.py:6). 0 = episode still running.
OUTCOME_RUNNING = 0
OUTCOME_GOAL = 1
OUTCOME_COLLISION = 2
OUTCOME_TIMEOUT = 3
OUTCOME_NAMES = {1: "Goal", 2: "Collision", 3: "Timeout"}


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """All ACAS-2D environment tunables (defaults == reference settings.py)."""

    # Episode limits (settings.py:9)
    max_steps: int = 1000

    # Airspace geometry (settings.py:15-16)
    width: float = 1600.0
    height: float = 1000.0

    # Simulated frame rate — only the integration dt = 1/fps survives in the
    # TPU build; the real-time `clock.tick(FPS)` throttle
    # (environment.py:31) is deliberately dropped.
    fps: float = 100.0

    # RNG (settings.py:28)
    seed: int = 13

    # Aircraft constants (settings.py:31-36)
    min_traffic: int = 1
    max_traffic: int = 1
    aircraft_size: float = 24.0
    collision_radius: float = 48.0       # 2 * aircraft_size
    goal_radius: float = 144.0           # 6 * aircraft_size
    safe_distance: float = 192.0         # 4 * collision_radius

    # Kinematics constants (settings.py:39-44)
    airspeed: float = 200.0
    airspeed_factor_min: float = 1.0
    airspeed_factor_max: float = 1.0
    acc_lat_limit: float = 20.0 * STANDARD_GRAVITY   # 196.133
    player_initial_heading_lim: float = 3.0
    traffic_initial_heading_lim: float = 15.0

    # Reward constants (settings.py:47-48)
    reward_goal: float = 1000.0
    reward_collision: float = -1000.0

    # --- engine behavior flags (new; no reference counterpart) -------------
    # Reproduce the reference's numerical quirks exactly (see ops/kinematics.py):
    #   * `arctan` (not atan2) in distance_closest_approach (kinematics.py:47)
    #   * missing /dt in closing_speed's psi_dot (kinematics.py:57,67)
    #   * AC1's v_air used for AC2's y-velocity (kinematics.py:74)
    # Set False for the physically-corrected versions.
    bug_compat: bool = True

    # ------------------------------------------------------------------ dt
    @property
    def dt(self) -> float:
        return 1.0 / self.fps

    # -------------------------------------------------- spawn geometry
    # Goal position (game.py:80-81).
    @property
    def goal_x(self) -> float:
        return self.width - self.goal_radius

    @property
    def goal_y(self) -> float:
        return self.height / 2.0

    # Player spawn (game.py:84-85) — deterministic.
    @property
    def player_x0(self) -> float:
        return self.collision_radius

    @property
    def player_y0(self) -> float:
        return self.height / 2.0

    # ------------------------------------------- observation normalizers
    # All five are episode-invariant because the player spawn is
    # deterministic (game.py:118-128 computes them from the t=0 state).
    @property
    def d_goal_spawn(self) -> float:
        """Player-to-goal distance at spawn (always along the x axis)."""
        return math.hypot(self.goal_x - self.player_x0,
                          self.goal_y - self.player_y0)

    @property
    def d_goal_max(self) -> float:
        # game.py:120 — spawn distance + max distance flyable in an episode.
        return self.d_goal_spawn + (self.airspeed / self.fps) * self.max_steps

    @property
    def d_dev_max(self) -> float:
        # game.py:122
        return (self.airspeed / self.fps) * self.max_steps

    @property
    def d_separation_max(self) -> float:
        # game.py:124
        return (math.hypot(self.width, self.height)
                + 2.0 * (self.airspeed / self.fps) * self.max_steps)

    @property
    def d_cpa_max(self) -> float:
        # game.py:126
        return math.hypot(self.width, self.height)

    @property
    def v_closing_max(self) -> float:
        # game.py:128
        return 2.0 * self.airspeed_factor_max * self.airspeed

    # ------------------------------------------------- reward constants
    @property
    def d_goal_init(self) -> float:
        # rewards.py:21,47 — NOT the same as d_goal_spawn: uses aircraft_size.
        return (self.width - self.goal_radius) - 2.0 * self.aircraft_size

    @property
    def d_dev_max_reward(self) -> float:
        # rewards.py:22 — reward-side deviation scale (704 by default),
        # distinct from the observation normalizer d_dev_max (2000).
        return self.d_goal_init / 2.0

    @property
    def d_goal_max_reward(self) -> float:
        # rewards.py:48
        return self.d_goal_init + (self.airspeed / self.fps) * self.max_steps

    # ------------------------------------------------------ obs layout
    @property
    def obs_dim(self) -> int:
        # environment.py:17 — 5 player features + 3 per traffic aircraft.
        return 5 + 3 * self.max_traffic


DEFAULT_PARAMS = EnvParams()
