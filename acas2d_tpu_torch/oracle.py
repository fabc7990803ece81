"""Scalar NumPy/math oracle of the reference ACAS-2D environment.

A copy of `acas2d_tpu/oracle.py`, which the port cannot import (the JAX
package's `__init__` imports jax): the reference environment's semantics
(`gym_ACAS2D/envs/{game,aircraft,kinematics,rewards,environment}.py`)
restated without pygame or gym, float for float.  It is the port's own
ground truth:

  * `MersenneSpawner` replays the reference's episode-spawn stream (the
    exact-protocol evals, the baseline driver, the gym adapters);
  * `OracleEnv` steps one episode in scalar float64, against which the
    engine (`envs/core.py`) and the gym adapters are held;
  * the scalar kinematics and rewards give the HUD's quantities
    (`render.hud_quantities`).

Every function cites the reference `file:line` whose behaviour it
reproduces.  Floating-point op *order* is kept identical to the reference
so results match bit for bit on the same libm.  The reference's numerical
quirks are reproduced when `params.bug_compat` (the default).

This module is scalar and slow on purpose: a fixture, not the engine.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from acas2d_tpu_torch.config import (
    EnvParams,
    DEFAULT_PARAMS,
    OUTCOME_COLLISION,
    OUTCOME_GOAL,
    OUTCOME_RUNNING,
    OUTCOME_TIMEOUT,
)

TWO_PI = 2 * math.pi


# =============================================================== geometry ops
# Scalar counterparts of gym_ACAS2D/envs/kinematics.py, same op order.

def distance(x1: float, y1: float, x2: float, y2: float) -> float:
    """Euclidean distance (kinematics.py:7-13, np.linalg.norm of the diff)."""
    dx = x1 - x2
    dy = y1 - y2
    return float(np.sqrt(dx * dx + dy * dy))


def relative_angle(x1: float, y1: float, x2: float, y2: float) -> float:
    """Bearing from (x1,y1) to (x2,y2) in degrees in [0,360).

    kinematics.py:16-22: degrees(atan2(dy,dx) mod 2*pi).  Screen coordinates:
    y grows downward, so angles are clockwise from +x.
    """
    rads = math.atan2(y2 - y1, x2 - x1) % TWO_PI
    return math.degrees(rads)


def relative_velocity(v1, psi1, v2, psi2) -> Tuple[float, float]:
    """Velocity of aircraft 1 relative to aircraft 2 (kinematics.py:25-37)."""
    psi1_rad = (psi1 / 360.0) * 2 * math.pi
    psi2_rad = (psi2 / 360.0) * 2 * math.pi
    v12x = v1 * np.cos(psi1_rad) - v2 * np.cos(psi2_rad)
    v12y = v1 * np.sin(psi1_rad) - v2 * np.sin(psi2_rad)
    return v12x, v12y


def distance_closest_approach(x1, y1, v1, psi1, x2, y2, v2, psi2,
                              bug_compat: bool = True) -> float:
    """Signed distance at closest point of approach (kinematics.py:40-49).

    Reference quirk (kept when bug_compat): relative-velocity heading is
    computed with single-argument arctan (kinematics.py:47), which collapses
    quadrants (arctan(v12y/v12x) == arctan((-v12y)/(-v12x))) and divides by
    zero when v12x == 0 (yielding +/-pi/2 via IEEE inf, or NaN for 0/0).
    """
    d = distance(x1, y1, x2, y2)
    a_rel_rad = (relative_angle(x1, y1, x2, y2) / 360.0) * 2 * math.pi
    v12x, v12y = relative_velocity(v1, psi1, v2, psi2)
    with np.errstate(divide="ignore", invalid="ignore"):
        if bug_compat:
            h_rel_rad = np.arctan(np.float64(v12y) / np.float64(v12x))
        else:
            h_rel_rad = np.arctan2(np.float64(v12y), np.float64(v12x))
    return float(d * np.sin(a_rel_rad - h_rel_rad))


def closing_speed(x1, y1, v1, psi1, a_lat1, x2, y2, v2, psi2, a_lat2,
                  p: EnvParams) -> float:
    """Closing speed between two aircraft (kinematics.py:52-79).

    Sign convention is INVERTED vs the name: positive result means the
    aircraft are separating (the dot of relative velocity with the relative
    position *from 2 to 1*).  Reference quirks (kept when p.bug_compat):
      * psi_dot omits the /dt that update_state applies (kinematics.py:57,67
        vs aircraft.py:20), so the one-step lookahead under-rotates by 1/dt;
      * aircraft 2's y-velocity uses aircraft 1's airspeed (kinematics.py:74).
    The velocity vectors are dt-scaled displacements; the final division by
    dt (kinematics.py:77) restores speed units.
    """
    dt = p.dt
    if p.bug_compat:
        psi_dot_1 = a_lat1 / v1
        psi_dot_2 = a_lat2 / v2
    else:
        psi_dot_1 = a_lat1 / (v1 * dt)
        psi_dot_2 = a_lat2 / (v2 * dt)
    psi_1 = (psi1 + (psi_dot_1 * dt)) % 360
    psi_rad_1 = (psi_1 / 360.0) * 2 * math.pi
    nx1 = x1 + (v1 * math.cos(psi_rad_1) * dt)
    ny1 = y1 + (v1 * math.sin(psi_rad_1) * dt)
    vx1 = v1 * math.cos(psi_rad_1) * dt
    vy1 = v1 * math.sin(psi_rad_1) * dt

    psi_2 = (psi2 + (psi_dot_2 * dt)) % 360
    psi_rad_2 = (psi_2 / 360.0) * 2 * math.pi
    nx2 = x2 + (v2 * math.cos(psi_rad_2) * dt)
    ny2 = y2 + (v2 * math.sin(psi_rad_2) * dt)
    vx2 = v2 * math.cos(psi_rad_2) * dt
    if p.bug_compat:
        vy2 = v1 * math.sin(psi_rad_2) * dt   # kinematics.py:74 uses v_air of AC1
    else:
        vy2 = v2 * math.sin(psi_rad_2) * dt

    dvx = vx1 - vx2
    dvy = vy1 - vy2
    dpx = nx1 - nx2
    dpy = ny1 - ny2
    return float((np.dot(np.array([dvx, dvy]), np.array([dpx, dpy]))
                  / distance(nx1, ny1, nx2, ny2)) / dt)


def delta_heading(psi: float, phi: float) -> float:
    """Smallest angular difference in degrees (kinematics.py:82-83)."""
    return min(abs(psi - phi), 360 - abs(psi - phi))


# ================================================================== rewards
# Scalar counterparts of gym_ACAS2D/envs/rewards.py.

def heading_reward(psi, phi, exp: float = 4) -> float:
    """(1 - delta_heading/180)^exp (rewards.py:5-9)."""
    return (1 - delta_heading(psi, phi) / 180) ** exp


def closest_approach_reward(v_closing, d_cpa, p: EnvParams, exp: float = 4):
    """1 if separating, else min(1, (d_cpa/SAFE_DISTANCE)^exp) (rewards.py:12-16).

    Note d_cpa is signed; even powers make the reward symmetric in its sign.
    """
    if v_closing > 0:
        return 1
    return min(1, (d_cpa / p.safe_distance) ** exp)


def plan_deviation_reward(d_dev, p: EnvParams, exp: float = 0.5):
    """(1 - |d_dev|/704)^exp, 0 beyond (rewards.py:19-27)."""
    d_dev = abs(d_dev)
    d_dev_max = p.d_dev_max_reward
    if d_dev > d_dev_max:
        return 0
    return (1 - d_dev / d_dev_max) ** exp


def goal_distance_reward(d_goal, p: EnvParams, exp: float = 4):
    """min(1, (1 - d_goal/d_goal_max)^exp) (rewards.py:44-50)."""
    return min(1, (1 - d_goal / p.d_goal_max_reward) ** exp)


def step_reward(v_closing, psi, phi, d_cpa, d_goal, d_dev, p: EnvParams):
    """step_reward_5 (rewards.py:53-60): multiplicative shaped reward with a
    branch on approach (v_closing <= 0) vs separation."""
    if v_closing <= 0:
        return (heading_reward(psi, phi)
                * closest_approach_reward(v_closing, d_cpa, p)
                * plan_deviation_reward(d_dev, p))
    return heading_reward(psi, phi) * goal_distance_reward(d_goal, p)


# ============================================================ episode spawn

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

    The reference seeds the *global* `random` module once per process
    (training_main.py:14, baseline_main.py:13, ...) and every
    `ACAS2DGame.__init__` consumes draws from that one Mersenne-Twister
    stream in a fixed order (game.py:41,88,91-92,98-114):

      1. randint(MIN_TRAFFIC, MAX_TRAFFIC)        -> num_traffic
      2. uniform(0, 360)                          -> drawn then overwritten
      3. uniform(-lim, +lim)                      -> player heading jitter
      4. per traffic aircraft n:
           n == 0: randint(0,1) starts_down; uniform(f_min,f_max) speed
                   factor; uniform(-15,15) heading jitter
           n  > 0: uniform(0, W-size) x; uniform(0, 3H/5) y;
                   uniform(f_min,f_max); uniform(0,360) heading

    We hold a private `random.Random(seed)` so the variable-length
    getrandbits consumption inside randint is reproduced exactly by CPython
    itself.  `skip_episodes` accounts for env constructions that happen
    before the first measured episode (e.g. `gym.make` + SB3 `check_env`
    each construct a game in baseline_main.py:19-22).
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
        # game.py:91-92 — bearing player->goal plus jitter.
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


# ============================================================== episode sim

@dataclasses.dataclass
class OracleState:
    """Scalar mirror of the per-episode mutable state in ACAS2DGame."""
    px: float
    py: float
    pv: float
    ppsi: float
    pa_lat: float
    num_traffic: int
    tx: np.ndarray
    ty: np.ndarray
    tv: np.ndarray
    tpsi: np.ndarray
    steps: int = 0
    total_reward: float = 0.0
    outcome: int = OUTCOME_RUNNING


class OracleEnv:
    """Functional mirror of ACAS2DEnv (environment.py:29-48) minus pygame.

    step order (environment.py:31-39, clock tick dropped):
        action -> integrate player then traffic -> observe (steps += 1)
        -> evaluate -> is_done
    reset: fresh spawn, then one observe (steps becomes 1).
    """

    def __init__(self, params: EnvParams = DEFAULT_PARAMS,
                 spawner: Optional[MersenneSpawner] = None):
        self.p = params
        self.spawner = spawner or MersenneSpawner(params)
        self.state: Optional[OracleState] = None
        # Per-episode trajectory records (game.py:43-75 subset used by tests).
        self.path: List[Tuple[float, float]] = []
        self.traffic_paths: List[List[Tuple[float, float]]] = []

    # ------------------------------------------------------------- helpers
    def _d_goal(self, s: OracleState) -> float:
        return distance(s.px, s.py, self.p.goal_x, self.p.goal_y)   # game.py:168

    def _h_goal(self, s: OracleState) -> float:
        return relative_angle(s.px, s.py, self.p.goal_x, self.p.goal_y)  # game.py:171

    def _plan_deviation(self, s: OracleState) -> float:
        # game.py:175-180: d_goal * sin(h_goal) == signed vertical offset.
        d_goal = self._d_goal(s)
        h_goal_rad = (self._h_goal(s) / 360.0) * 2 * math.pi
        return float(d_goal * np.sin(h_goal_rad))

    def _min_separation(self, s: OracleState) -> float:
        # game.py:162-166
        return min(distance(s.px, s.py, s.tx[n], s.ty[n])
                   for n in range(s.num_traffic))

    def _collision(self, s: OracleState) -> bool:
        # game.py:185-189 — threshold is 2*COLLISION_RADIUS.
        return any(distance(s.px, s.py, s.tx[n], s.ty[n])
                   < 2 * self.p.collision_radius
                   for n in range(s.num_traffic))

    def _goal_reached(self, s: OracleState) -> bool:
        return self._d_goal(s) < self.p.goal_radius                 # game.py:191

    def _traffic_pair(self, s: OracleState, n: int = 0):
        """(v_closing, d_cpa) of player vs traffic n (game.py:254-255)."""
        v_c = closing_speed(s.px, s.py, s.pv, s.ppsi, s.pa_lat,
                            s.tx[n], s.ty[n], s.tv[n], s.tpsi[n], 0.0, self.p)
        d_cpa = distance_closest_approach(
            s.px, s.py, s.pv, s.ppsi, s.tx[n], s.ty[n], s.tv[n], s.tpsi[n],
            bug_compat=self.p.bug_compat)
        return v_c, d_cpa

    @staticmethod
    def _integrate(x, y, v, psi, a_lat, dt):
        """Unicycle Euler step in degree-space (aircraft.py:16-26).

        psi_dot = a_lat/(v*dt) then psi += psi_dot*dt: the net heading change
        per step is a_lat/v *degrees*.  Same float op order as the reference.
        """
        psi_dot = a_lat / (v * dt)
        psi = (psi + (psi_dot * dt)) % 360
        psi_rad = (psi / 360.0) * 2 * math.pi
        x = x + (v * math.cos(psi_rad) * dt)
        y = y + (v * math.sin(psi_rad) * dt)
        return x, y, psi

    # ----------------------------------------------------------------- API
    def reset(self) -> np.ndarray:
        init = self.spawner.spawn()
        self.state = OracleState(
            px=self.p.player_x0, py=self.p.player_y0, pv=self.p.airspeed,
            ppsi=init.player_psi, pa_lat=0.0,
            num_traffic=init.num_traffic,
            tx=init.traffic_x.copy(), ty=init.traffic_y.copy(),
            tv=init.traffic_v.copy(), tpsi=init.traffic_psi.copy())
        self.path = [(self.state.px, self.state.py)]
        self.traffic_paths = [[(self.state.tx[n], self.state.ty[n])]
                              for n in range(init.num_traffic)]
        return self.observe()

    def observe(self) -> np.ndarray:
        """game.py:194-218 — increments the step counter, then builds the
        8-vector [t, psi, d_dev, d_goal, h_goal, (d_sep, d_cpa, v_c)*]."""
        s = self.state
        p = self.p
        s.steps += 1
        obs = [s.steps / p.max_steps,
               s.ppsi / 360,
               self._plan_deviation(s) / p.d_dev_max,
               self._d_goal(s) / p.d_goal_max,
               self._h_goal(s) / 360]
        for n in range(s.num_traffic):
            obs.append(distance(s.px, s.py, s.tx[n], s.ty[n]) / p.d_separation_max)
            v_c, d_cpa = self._traffic_pair(s, n)
            obs.append(d_cpa / p.d_cpa_max)
            obs.append(v_c / p.v_closing_max)
        # Reference pads 2 (not 3) zeros per absent aircraft (game.py:213).
        obs += [0] * (2 * (p.max_traffic - s.num_traffic))
        return np.array(obs).astype(np.float64)

    def step(self, action: Sequence[float]):
        s = self.state
        p = self.p
        # --- action phase (game.py:222-247): player integrates first, then
        # traffic (straight-line, a_lat always 0).
        s.pa_lat = action[0] * p.acc_lat_limit
        s.px, s.py, s.ppsi = self._integrate(s.px, s.py, s.pv, s.ppsi,
                                             s.pa_lat, p.dt)
        self.path.append((s.px, s.py))
        for n in range(s.num_traffic):
            self.traffic_paths[n].append((s.tx[n], s.ty[n]))
        for n in range(s.num_traffic):
            s.tx[n], s.ty[n], s.tpsi[n] = self._integrate(
                s.tx[n], s.ty[n], s.tv[n], s.tpsi[n], 0.0, p.dt)
        # --- observe phase (environment.py:35): steps increments here.
        obs = self.observe()
        # --- evaluate phase (game.py:249-292).
        psi = s.ppsi
        phi = self._h_goal(s)
        v_c, d_cpa = self._traffic_pair(s, 0)
        d_goal = self._d_goal(s)
        d_dev = self._plan_deviation(s)
        r = step_reward(v_c, psi, phi, d_cpa, d_goal, d_dev, p)
        reward = r * (1 - (s.steps / p.max_steps))    # time discount, game.py:259-261
        if self._collision(s):
            reward += p.reward_collision
        if self._goal_reached(s):
            reward += p.reward_goal
        s.total_reward += reward
        # --- termination (game.py:294-314): timeout > collision > goal.
        done = False
        if s.steps > p.max_steps:
            s.outcome, done = OUTCOME_TIMEOUT, True
        elif self._collision(s):
            s.outcome, done = OUTCOME_COLLISION, True
        elif self._goal_reached(s):
            s.outcome, done = OUTCOME_GOAL, True
        return obs, reward, done, {}

    # ------------------------------------------------------------ rollouts
    def run_episode(self, policy=None, max_steps: Optional[int] = None):
        """Run one episode; policy(obs, t) -> [a] (defaults to zero action)."""
        obs = self.reset()
        limit = max_steps if max_steps is not None else self.p.max_steps
        rewards = []
        for t in range(limit):
            a = np.array([0]) if policy is None else policy(obs, t)
            obs, r, done, _ = self.step(a)
            rewards.append(r)
            if done:
                break
        return {
            "outcome": self.state.outcome,
            "steps": self.state.steps,
            "total_reward": self.state.total_reward,
            "rewards": rewards,
            "path": list(self.path),
            "traffic_paths": [list(tp) for tp in self.traffic_paths],
        }
