"""The ACAS-2D environment's arithmetic, written out plainly for the
benchmark's reference.

Two statements of one environment (github.com/Christos-14/gym-ACAS2D,
`settings.py`, `game.py`, `kinematics.py`, `rewards.py`), frozen here so
that later changes to the program cannot move the yardstick:

  * the kernels' statement (`KernelEnv`): one traffic aircraft at the
    player's speed, the reference's three `bug_compat` quirks, the
    counter-based hash RNG and a polynomial arctan, as the training
    rollout and the env rollout run it;
  * the engine's statement (`observe`, `step`, `spawn_*`): the general
    step of the greedy evals and the first observation of a spawn, with
    torch's own arctan.

Everything runs in the dtype of its inputs, so the same code serves the
float32 reference and its lower-precision control.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

LANES = 8 * 128
DEG2RAD = math.pi / 180.0
TWO_PI = 2.0 * math.pi
RAD_TO_DEG = 180.0 / math.pi
M32 = 0xFFFFFFFF
G = 9.80665


def f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Env:
    """The reference settings (settings.py) that the benchmark runs."""
    max_steps: int = 1000
    width: float = 1600.0
    height: float = 1000.0
    fps: float = 100.0
    collision_radius: float = 48.0
    goal_radius: float = 144.0
    safe_distance: float = 192.0
    aircraft_size: float = 24.0
    airspeed: float = 200.0
    acc_lat_limit: float = 20.0 * G
    player_heading_lim: float = 3.0
    traffic_heading_lim: float = 15.0
    reward_goal: float = 1000.0
    reward_collision: float = -1000.0

    @property
    def dt(self):
        return 1.0 / self.fps

    @property
    def goal_x(self):
        return self.width - self.goal_radius

    @property
    def goal_y(self):
        return self.height / 2.0

    @property
    def player_x0(self):
        return self.collision_radius

    @property
    def player_y0(self):
        return self.height / 2.0

    @property
    def d_goal_max(self):
        return (math.hypot(self.goal_x - self.player_x0,
                           self.goal_y - self.player_y0)
                + self.airspeed / self.fps * self.max_steps)

    @property
    def d_dev_max(self):
        return self.airspeed / self.fps * self.max_steps

    @property
    def d_separation_max(self):
        return (math.hypot(self.width, self.height)
                + 2.0 * self.airspeed / self.fps * self.max_steps)

    @property
    def d_cpa_max(self):
        return math.hypot(self.width, self.height)

    @property
    def v_closing_max(self):
        return 2.0 * self.airspeed

    @property
    def d_goal_init(self):
        return (self.width - self.goal_radius) - 2.0 * self.aircraft_size

    @property
    def d_dev_max_reward(self):
        return self.d_goal_init / 2.0

    @property
    def d_goal_max_reward(self):
        return self.d_goal_init + self.airspeed / self.fps * self.max_steps


ENV = Env()


def constants(p: Env = ENV) -> Dict[str, float]:
    """The kernels' float32 constants, each a float64 value rounded once."""
    bearing = f32(math.degrees(math.atan2(p.goal_y - p.player_y0,
                                          p.goal_x - p.player_x0) % TWO_PI))
    return {
        "dt": f32(p.dt), "v": f32(p.airspeed), "acc": f32(p.acc_lat_limit),
        "gx": f32(p.goal_x), "gy": f32(p.goal_y),
        "inv_max_steps": f32(1.0 / p.max_steps), "bearing": bearing,
        "player_x0": f32(p.player_x0), "player_y0": f32(p.player_y0),
        "traffic_x0": f32(p.width - p.collision_radius),
        "traffic_y_top": f32(p.collision_radius),
        "traffic_y_span": f32(p.height - 2 * p.collision_radius),
        "player_lim": f32(p.player_heading_lim),
        "traffic_lim": f32(p.traffic_heading_lim),
        "coll_dist": f32(2 * p.collision_radius),
        "goal_radius": f32(p.goal_radius),
        "reward_collision": f32(p.reward_collision),
        "reward_goal": f32(p.reward_goal),
        "inv_safe": f32(1.0 / p.safe_distance),
        "inv_dev_reward": f32(1.0 / p.d_dev_max_reward),
        "inv_goal_reward": f32(1.0 / p.d_goal_max_reward),
        "inv_d_dev_max": f32(1.0 / p.d_dev_max),
        "inv_d_goal_max": f32(1.0 / p.d_goal_max),
        "inv_d_sep_max": f32(1.0 / p.d_separation_max),
        "inv_d_cpa_max": f32(1.0 / p.d_cpa_max),
        "inv_v_closing_max": f32(1.0 / p.v_closing_max),
        "half_log_2pi": f32(0.5 * math.log(2.0 * math.pi)),
    }


# ------------------------------------------------------------ hash RNG

def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _triple32(x):
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x31848BAB)
    return x ^ (x >> 14)


def rng_base(seed: int, n: int, device) -> torch.Tensor:
    """Env e's stream: seed*0x9E3779B9 + (e // 1024)*0xC2B2AE35 +
    (e % 1024)*0x27D4EB2F mod 2^32, the seed as its int32 bit pattern."""
    ids = torch.arange(n, device=device, dtype=torch.int64)
    s = ((int(seed) & M32) * 0x9E3779B9) & M32
    return (s + _mul32(ids // LANES, 0xC2B2AE35)
            + _mul32(ids % LANES, 0x27D4EB2F)) & M32


def uniform(base: torch.Tensor, step: int, salt: int) -> torch.Tensor:
    """float32 in [0, 1): the top 24 bits of triple32(base + step*0x7FEB352D
    + salt*0x85EBCA6B)."""
    h = _triple32((base + ((step & M32) * 0x7FEB352D & M32)
                   + ((salt & M32) * 0x85EBCA6B & M32)) & M32)
    return (h >> 8).to(torch.float32) * f32(1.0 / (1 << 24))


# ------------------------------------------------ the kernels' statement

def _atan(x):
    """Cephes float32 arctan: two-interval reduction, odd polynomial."""
    ax = torch.abs(x)
    big = ax > 2.414213562373095
    mid = ax > 0.4142135623730950
    safe = torch.clamp(ax, min=f32(1e-30))
    xr = torch.where(big, -1.0 / safe,
                     torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    off = torch.where(big, f32(math.pi / 2),
                      torch.where(mid, f32(math.pi / 4), 0.0))
    z = xr * xr
    y = (((f32(8.05374449538e-2) * z - f32(1.38776856032e-1)) * z
          + f32(1.99777106478e-1)) * z - f32(3.33329491539e-1)) * z * xr + xr
    return torch.sign(x) * (off + y)


def _atan2(y, x):
    safe_x = torch.where(x == 0.0, 1.0, x)
    base = _atan(y / safe_x)
    pi = f32(math.pi)
    res = torch.where(x > 0.0, base,
                      torch.where(y >= 0.0, base + pi, base - pi))
    return torch.where(x == 0.0, torch.where(
        y > 0.0, pi / 2, torch.where(y < 0.0, -pi / 2, 0.0)), res)


def mod360(x):
    return x - 360.0 * torch.floor(x * f32(1.0 / 360.0))


def _mod2pi(x):
    return x - TWO_PI * torch.floor(x / TWO_PI)


def respawn(u_psi, u_side, u_tpsi, c):
    """A fresh episode from three uniforms: (px, py, psi, tx, ty, tv,
    tpsi)."""
    psi = mod360(c["bearing"] + (u_psi * 2.0 - 1.0) * c["player_lim"])
    down = (u_side < 0.5).to(psi.dtype)
    ty = c["traffic_y_top"] + down * c["traffic_y_span"]
    tpsi = mod360(145.0 + down * 70.0 + (u_tpsi * 2.0 - 1.0) * c["traffic_lim"])
    return (torch.full_like(psi, c["player_x0"]),
            torch.full_like(psi, c["player_y0"]), psi,
            torch.full_like(psi, c["traffic_x0"]), ty,
            torch.full_like(psi, c["v"]), tpsi)


def geometry(px, py, cp, sp, psi, tx, ty, tv, tcos, tsin, a_lat, c):
    """(d_goal, h_goal_rad, d_dev, d_sep, d_cpa, v_closing) with the
    reference's quirks: arctan for the closest approach, no /dt in the
    lookahead's turn, the player's speed in the traffic's y-velocity."""
    v, dt = c["v"], c["dt"]
    dxg, dyg = c["gx"] - px, c["gy"] - py
    d_goal = torch.sqrt(dxg * dxg + dyg * dyg)
    h_goal = _mod2pi(_atan2(dyg, dxg))
    d_dev = d_goal * torch.sin(h_goal)
    dxt, dyt = tx - px, ty - py
    d_sep = torch.sqrt(dxt * dxt + dyt * dyt)
    v12x = v * cp - tv * tcos
    v12y = v * sp - tv * tsin
    h_rel = _atan(v12y / torch.where(v12x == 0.0, f32(1e-30), v12x))
    d_cpa = d_sep * torch.sin(_mod2pi(_atan2(dyt, dxt)) - h_rel)
    p1 = (psi + (a_lat / v) * dt) * DEG2RAD
    vx1, vy1 = v * torch.cos(p1) * dt, v * torch.sin(p1) * dt
    vx2, vy2 = tv * tcos * dt, v * tsin * dt
    dpx = (px + vx1) - (tx + vx2)
    dpy = (py + vy1) - (ty + tv * tsin * dt)
    nd = torch.sqrt(dpx * dpx + dpy * dpy)
    v_closing = (((vx1 - vx2) * dpx + (vy1 - vy2) * dpy) / nd) / dt
    return d_goal, h_goal, d_dev, d_sep, d_cpa, v_closing


def shaped_reward(psi, h_goal_deg, d_goal, d_dev, d_cpa, v_closing, c):
    """step_reward_5 of rewards.py."""
    def pow4(x):
        sq = x * x
        return sq * sq
    dh = torch.abs(psi - h_goal_deg)
    dh = torch.minimum(dh, 360.0 - dh)
    r_head = pow4(1.0 - dh * f32(1.0 / 180.0))
    r_cpa = torch.clamp(pow4(d_cpa * c["inv_safe"]), max=1.0)
    frac = torch.abs(d_dev) * c["inv_dev_reward"]
    r_dev = torch.where(frac > 1.0, 0.0,
                        torch.sqrt(torch.clamp(1.0 - frac, min=0.0)))
    r_goal = torch.clamp(pow4(1.0 - d_goal * c["inv_goal_reward"]), max=1.0)
    return r_head * torch.where(v_closing <= 0, r_cpa * r_dev, r_goal)


def features(steps, psi, d_goal, h_goal, d_dev, d_sep, d_cpa, v_closing, c):
    """The eight observation features, (B, 8)."""
    return torch.stack([
        steps.to(psi.dtype) * c["inv_max_steps"], psi * f32(1.0 / 360.0),
        d_dev * c["inv_d_dev_max"], d_goal * c["inv_d_goal_max"],
        (h_goal * f32(1.0 / DEG2RAD)) * f32(1.0 / 360.0),
        d_sep * c["inv_d_sep_max"], d_cpa * c["inv_d_cpa_max"],
        v_closing * c["inv_v_closing_max"]], dim=-1)


class KernelEnv:
    """B envs stepped as the kernels state the step: `advance` moves every
    env one step under a lateral acceleration and scores it, `respawn`
    replaces the ended ones, `observe` gives the post-step features."""

    def __init__(self, st: Dict[str, torch.Tensor], steps: torch.Tensor,
                 total: torch.Tensor, c: Dict[str, float], max_steps: int):
        self.c, self.max_steps = c, max_steps
        for k in ("px", "py", "psi", "tx", "ty", "tv", "tpsi"):
            setattr(self, k, st[k])
        self.steps, self.total = steps, total
        tr = self.tpsi * DEG2RAD
        self.tcos, self.tsin = torch.cos(tr), torch.sin(tr)

    def advance(self, a_lat):
        """One step: (reward, done, outcome, collided, at_goal, in_time)."""
        c = self.c
        v, dt = c["v"], c["dt"]
        self.psi = mod360(self.psi + a_lat / v)
        pr = self.psi * DEG2RAD
        cp, sp = torch.cos(pr), torch.sin(pr)
        self.px = self.px + v * cp * dt
        self.py = self.py + v * sp * dt
        self.tx = self.tx + self.tv * self.tcos * dt
        self.ty = self.ty + self.tv * self.tsin * dt
        self.steps = self.steps + 1
        d_goal, h_goal, d_dev, d_sep, d_cpa, v_cl = geometry(
            self.px, self.py, cp, sp, self.psi, self.tx, self.ty, self.tv,
            self.tcos, self.tsin, a_lat, c)
        r = shaped_reward(self.psi, h_goal * f32(1.0 / DEG2RAD), d_goal,
                          d_dev, d_cpa, v_cl, c)
        collided = d_sep < c["coll_dist"]
        at_goal = d_goal < c["goal_radius"]
        in_time = self.steps <= self.max_steps
        tdf = 1.0 - self.steps.to(r.dtype) * c["inv_max_steps"]
        reward = (r * tdf + torch.where(collided, c["reward_collision"], 0.0)
                  + torch.where(at_goal, c["reward_goal"], 0.0))
        self.total = self.total + reward
        done = ~in_time | collided | at_goal
        outcome = torch.where(~in_time, 3, torch.where(
            collided, 2, torch.where(at_goal, 1, 0))).to(torch.int32)
        return reward, done, outcome, collided, at_goal, in_time

    def respawn(self, done, base, step):
        c = self.c
        dt_ = self.px.dtype
        fresh = respawn(uniform(base, step, 1).to(dt_),
                        uniform(base, step, 2).to(dt_),
                        uniform(base, step, 3).to(dt_), c)
        for k, f in zip(("px", "py", "psi", "tx", "ty", "tv", "tpsi"), fresh):
            setattr(self, k, torch.where(done, f, getattr(self, k)))
        ftr = fresh[6] * DEG2RAD
        self.tcos = torch.where(done, torch.cos(ftr), self.tcos)
        self.tsin = torch.where(done, torch.sin(ftr), self.tsin)
        self.steps = torch.where(done, 1, self.steps).to(torch.int32)
        self.total = torch.where(done, 0.0, self.total)

    def observe(self, a_live):
        pr = self.psi * DEG2RAD
        geo = geometry(self.px, self.py, torch.cos(pr), torch.sin(pr),
                       self.psi, self.tx, self.ty, self.tv, self.tcos,
                       self.tsin, a_live, self.c)
        return features(self.steps, self.psi, *geo, self.c)


# ------------------------------------------------ the engine's statement

def _deg_to_rad(psi):
    return (psi / 360.0) * 2 * math.pi


def _distance(x1, y1, x2, y2):
    dx, dy = x1 - x2, y1 - y2
    return torch.sqrt(dx * dx + dy * dy)


def _bearing(x1, y1, x2, y2):
    return torch.remainder(torch.atan2(y2 - y1, x2 - x1), TWO_PI) * RAD_TO_DEG


def _cpa(x1, y1, v1, psi1, x2, y2, v2, psi2):
    d = _distance(x1, y1, x2, y2)
    a_rel = _deg_to_rad(_bearing(x1, y1, x2, y2))
    p1, p2 = _deg_to_rad(psi1), _deg_to_rad(psi2)
    v12x = v1 * torch.cos(p1) - v2 * torch.cos(p2)
    v12y = v1 * torch.sin(p1) - v2 * torch.sin(p2)
    denom = torch.where((v12x == 0) & (v12y == 0), 1.0, v12x)
    return d * torch.sin(a_rel - torch.atan(v12y / denom))


def _closing(x1, y1, v1, psi1, a1, x2, y2, v2, psi2, dt):
    p1 = _deg_to_rad(torch.remainder(psi1 + (a1 / v1) * dt, 360))
    p2 = _deg_to_rad(torch.remainder(psi2 + (0.0 / v2) * dt, 360))
    vx1, vy1 = v1 * torch.cos(p1) * dt, v1 * torch.sin(p1) * dt
    vx2, vy2 = v2 * torch.cos(p2) * dt, v1 * torch.sin(p2) * dt
    nx1, ny1 = x1 + vx1, y1 + vy1
    nx2, ny2 = x2 + vx2, y2 + v2 * torch.sin(p2) * dt
    num = (vx1 - vx2) * (nx1 - nx2) + (vy1 - vy2) * (ny1 - ny2)
    d = _distance(nx1, ny1, nx2, ny2)
    return (num / torch.where(d == 0, 1.0, d)) / dt


@dataclasses.dataclass
class State:
    """One traffic aircraft's episode, (B,) fields."""
    px: torch.Tensor
    py: torch.Tensor
    psi: torch.Tensor
    a_lat: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    tv: torch.Tensor
    tpsi: torch.Tensor
    steps: torch.Tensor
    total: torch.Tensor


def observe(s: State, p: Env = ENV) -> Tuple[State, torch.Tensor]:
    """The engine's observation; counts the step first."""
    s = dataclasses.replace(s, steps=s.steps + 1)
    d_sep = _distance(s.px, s.py, s.tx, s.ty)
    v_c = _closing(s.px, s.py, p.airspeed, s.psi, s.a_lat, s.tx, s.ty, s.tv,
                   s.tpsi, p.dt)
    d_cpa = _cpa(s.px, s.py, p.airspeed, s.psi, s.tx, s.ty, s.tv, s.tpsi)
    gx, gy = torch.full_like(s.px, p.goal_x), torch.full_like(s.py, p.goal_y)
    d_goal = _distance(s.px, s.py, p.goal_x, p.goal_y)
    h_goal = _bearing(s.px, s.py, gx, gy)
    d_dev = d_goal * torch.sin(_deg_to_rad(h_goal))
    obs = torch.stack([s.steps.to(s.px.dtype) / p.max_steps, s.psi / 360,
                       d_dev / p.d_dev_max, d_goal / p.d_goal_max,
                       h_goal / 360, d_sep / p.d_separation_max,
                       d_cpa / p.d_cpa_max, v_c / p.v_closing_max], dim=-1)
    return s, obs


def step(s: State, action, p: Env = ENV):
    """One transition of the engine under actions in [-1, 1]: (state,
    obs, reward, outcome)."""
    dt, v = p.dt, p.airspeed
    a_lat = action.to(s.px.dtype) * p.acc_lat_limit

    def integrate(x, y, vv, psi, a):
        psi = torch.remainder(psi + (a / (vv * dt)) * dt, 360)
        r = _deg_to_rad(psi)
        return x + vv * torch.cos(r) * dt, y + vv * torch.sin(r) * dt, psi

    px, py, psi = integrate(s.px, s.py, v, s.psi, a_lat)
    tx, ty, tpsi = integrate(s.tx, s.ty, s.tv, s.tpsi,
                             torch.zeros_like(s.tx))
    s = dataclasses.replace(s, px=px, py=py, psi=psi, a_lat=a_lat, tx=tx,
                            ty=ty, tpsi=tpsi)
    s, obs = observe(s, p)
    gx, gy = torch.full_like(s.px, p.goal_x), torch.full_like(s.py, p.goal_y)
    phi = _bearing(s.px, s.py, gx, gy)
    v_c = _closing(s.px, s.py, v, s.psi, s.a_lat, s.tx, s.ty, s.tv, s.tpsi,
                   dt)
    d_cpa = _cpa(s.px, s.py, v, s.psi, s.tx, s.ty, s.tv, s.tpsi)
    d_goal = _distance(s.px, s.py, p.goal_x, p.goal_y)
    d_dev = d_goal * torch.sin(_deg_to_rad(phi))

    def pow4(x):
        sq = x * x
        return sq * sq
    dh = torch.abs(s.psi - phi)
    dh = torch.minimum(dh, 360.0 - dh)
    r_head = pow4(1 - dh / 180)
    r_cpa = torch.where(v_c > 0, 1.0, torch.clamp(
        pow4(d_cpa / p.safe_distance), max=1.0))
    frac = torch.abs(d_dev) / p.d_dev_max_reward
    r_dev = torch.where(frac > 1.0, 0.0,
                        torch.sqrt(torch.clamp(1 - frac, min=0.0)))
    r_goal = torch.clamp(pow4(1 - d_goal / p.d_goal_max_reward), max=1.0)
    r = r_head * torch.where(v_c <= 0, r_cpa * r_dev, r_goal)
    collided = _distance(s.px, s.py, s.tx, s.ty) < 2 * p.collision_radius
    at_goal = d_goal < p.goal_radius
    reward = (r * (1 - s.steps.to(s.px.dtype) / p.max_steps)
              + torch.where(collided, p.reward_collision, 0.0)
              + torch.where(at_goal, p.reward_goal, 0.0)).to(s.px.dtype)
    outcome = torch.where(s.steps > p.max_steps, 3, torch.where(
        collided, 2, torch.where(at_goal, 1, 0))).to(torch.int32)
    s = dataclasses.replace(s, total=s.total + reward)
    return s, obs, reward, outcome


def _spawned(psi_u, down, v_u, h_u, dtype, device, p: Env = ENV) -> State:
    """A spawn from its float64 draws (game.py:84-106), cast to `dtype`."""
    n = psi_u.shape[0]
    bearing = math.degrees(math.atan2(p.goal_y - p.player_y0,
                                      p.goal_x - p.player_x0) % TWO_PI)
    lim = p.player_heading_lim
    psi = torch.remainder(bearing + (-lim + 2 * lim * psi_u), 360)
    ty = p.collision_radius + down * (p.height - 2 * p.collision_radius)
    tv = (1.0 + 0.0 * v_u) * p.airspeed
    tlim = p.traffic_heading_lim
    tpsi = torch.remainder(145 + down * 70 + (-tlim + 2 * tlim * h_u), 360)

    def f(x):
        return x.to(device=device, dtype=dtype)

    zeros = torch.zeros(n, dtype=dtype, device=device)
    return State(px=torch.full((n,), p.player_x0, dtype=dtype, device=device),
                 py=torch.full((n,), p.player_y0, dtype=dtype, device=device),
                 psi=f(psi), a_lat=zeros,
                 tx=torch.full((n,), p.width - p.collision_radius,
                               dtype=dtype, device=device),
                 ty=f(ty), tv=f(tv), tpsi=f(tpsi),
                 steps=torch.zeros(n, dtype=torch.int32, device=device),
                 total=zeros.clone())


def spawn_uniforms(u: torch.Tensor, dtype=torch.float32) -> State:
    """A spawn from (n, 5) uniforms: the traffic count (always one), the
    heading jitter, the corner, the speed factor (fixed at one) and the
    traffic's heading jitter, each from its own column."""
    u = u.to(torch.float64)
    return _spawned(u[:, 1], (u[:, 2] < 0.5).to(torch.float64), u[:, 3],
                    u[:, 4], dtype, u.device)


def spawn_generator(n: int, generator: torch.Generator, dtype, device
                    ) -> State:
    """A spawn drawn from a host generator in the engine's order: the
    traffic count, the heading jitter, the corner, the speed factor and
    the traffic's heading jitter, n of each."""
    torch.randint(1, 2, (n,), generator=generator)
    psi_u = torch.rand((n,), generator=generator, dtype=torch.float64)
    down = torch.randint(0, 2, (n,), generator=generator).to(torch.float64)
    v_u = torch.rand((n,), generator=generator, dtype=torch.float64)
    h_u = torch.rand((n,), generator=generator, dtype=torch.float64)
    return _spawned(psi_u, down, v_u, h_u, dtype, device)
