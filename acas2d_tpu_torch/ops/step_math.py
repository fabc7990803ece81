"""Shared device math of the fused kernels, in plain torch (float32).

Counterpart of `acas2d_tpu/ops/pallas_step.py:48-202`, and the plain version
of the CUDA `__device__` functions in `csrc/step_math.cuh`: the counter-based
hash RNG, the Cephes arctan, the angle wraps, and the environment step as the
kernels state it (specialised to one constant-speed traffic aircraft and the
reference's `bug_compat` quirks, kinematics.py:47,57,67,74).

Op order and float32 constants follow the Pallas kernels, so that the plain
version reproduces them to float32 rounding and the hash bit for bit.  The
hash runs in int64 with 32-bit masks: torch has no `>>` for uint32 on the
CPU.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from acas2d_tpu_torch.config import EnvParams

LANES = 8 * 128          # envs per program of the Pallas kernels (RNG layout)
DEG2RAD = math.pi / 180.0
TWO_PI = 2.0 * math.pi
M32 = 0xFFFFFFFF


def f32(x) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


# ------------------------------------------------------------- hash RNG

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without int64
    overflow (the product is split at 16 bits)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _triple32(x: torch.Tensor) -> torch.Tensor:
    """The triple32 32-bit integer finalizer (pallas_step.py:48-57)."""
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x31848BAB)
    x = x ^ (x >> 14)
    return x


def _term(v, c: int):
    """(v * c) mod 2^32 of an int or an integer tensor (its 32-bit
    pattern)."""
    if isinstance(v, torch.Tensor):
        return _mul32(v.to(torch.int64) & M32, c)
    return ((int(v) & M32) * c) & M32


def rng_base(seed, env_ids: torch.Tensor) -> torch.Tensor:
    """Per-env RNG base of the kernels (pallas_policy.py:89-95): env e is
    lane e % 1024 of program e // 1024, and the base is
    seed*0x9E3779B9 + program*0xC2B2AE35 + lane*0x27D4EB2F mod 2^32, the
    seed taken as its int32 bit pattern.  `seed`: an int, or an integer
    tensor that broadcasts against `env_ids` (a (1,) seed on the card,
    which a CUDA graph's replays read anew)."""
    ids = env_ids.to(torch.int64)
    return (_term(seed, 0x9E3779B9) + _mul32(ids // LANES, 0xC2B2AE35)
            + _mul32(ids % LANES, 0x27D4EB2F)) & M32


def hash32(base: torch.Tensor, step, salt) -> torch.Tensor:
    """triple32(base + step*0x7FEB352D + salt*0x85EBCA6B), in [0, 2^32)
    held in int64 (pallas_step.py:60)."""
    return _triple32((base + _term(step, 0x7FEB352D)
                      + _term(salt, 0x85EBCA6B)) & M32)


def _u01_hash(base: torch.Tensor, step, salt) -> torch.Tensor:
    """Float32 uniform in [0, 1): the top 24 bits of `hash32`."""
    return (hash32(base, step, salt) >> 8).to(torch.float32) * f32(
        1.0 / (1 << 24))


# ------------------------------------------------------------- arctan

def _atan(x: torch.Tensor) -> torch.Tensor:
    """Branchless f32 arctan (pallas_step.py:80-99): Cephes two-interval
    argument reduction and an odd polynomial, max error ~3e-7 rad."""
    ax = torch.abs(x)
    big = ax > 2.414213562373095      # tan(3*pi/8)
    mid = ax > 0.4142135623730950     # tan(pi/8)
    safe = torch.clamp(ax, min=f32(1e-30))
    xr = torch.where(big, -1.0 / safe,
                     torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    off = torch.where(big, f32(math.pi / 2),
                      torch.where(mid, f32(math.pi / 4), 0.0))
    z = xr * xr
    y = (((f32(8.05374449538e-2) * z
           - f32(1.38776856032e-1)) * z
          + f32(1.99777106478e-1)) * z
         - f32(3.33329491539e-1)) * z * xr + xr
    return torch.sign(x) * (off + y)


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 atan2 from _atan with quadrant fixup, range (-pi, pi]."""
    safe_x = torch.where(x == 0.0, 1.0, x)
    base = _atan(y / safe_x)
    pi = f32(math.pi)
    res = torch.where(x > 0.0, base,
                      torch.where(y >= 0.0, base + pi, base - pi))
    return torch.where(x == 0.0,
                       torch.where(y > 0.0, pi / 2,
                                   torch.where(y < 0.0, -pi / 2, 0.0)),
                       res)


def _mod360(x: torch.Tensor) -> torch.Tensor:
    return x - 360.0 * torch.floor(x * f32(1.0 / 360.0))


def _mod2pi(x: torch.Tensor) -> torch.Tensor:
    return x - TWO_PI * torch.floor(x / TWO_PI)


# ------------------------------------------------------------- constants

# Order of the fields of `RolloutConsts` in csrc/policy_rollout.cu.
CONST_NAMES = (
    "dt", "v", "acc", "gx", "gy", "inv_max_steps", "bearing",
    "player_x0", "player_y0", "traffic_x0", "traffic_y_top",
    "traffic_y_span", "player_lim", "traffic_lim", "coll_dist",
    "goal_radius", "reward_collision", "reward_goal", "inv_safe",
    "inv_dev_reward", "inv_goal_reward", "inv_d_dev_max", "inv_d_goal_max",
    "inv_d_sep_max", "inv_d_cpa_max", "inv_v_closing_max", "half_log_2pi")


def check_params(p: EnvParams) -> None:
    """The kernels specialise the reference's only exercised configuration
    (pallas_policy.py:311-319): one traffic aircraft at the player's speed,
    and the bug_compat kinematics."""
    if not (p.max_traffic == 1 and p.min_traffic == 1):
        raise ValueError("the fused kernels need min_traffic == max_traffic "
                         f"== 1 (got {p.min_traffic}..{p.max_traffic})")
    if not (p.airspeed_factor_min == 1.0 and p.airspeed_factor_max == 1.0):
        raise ValueError("the fused kernels' respawn fixes traffic speed to "
                         "the airspeed")
    if not p.bug_compat:
        raise ValueError("the fused kernels implement the bug_compat "
                         "kinematics only; use envs/core.py for corrected "
                         "physics")


def goal_bearing(p: EnvParams) -> float:
    """Initial player bearing to the goal in degrees (game.py:91), f32."""
    return f32(math.degrees(math.atan2(p.goal_y - p.player_y0,
                                       p.goal_x - p.player_x0) % TWO_PI))


def kernel_constants(p: EnvParams) -> Dict[str, float]:
    """The float32 constants of the kernels, each a float64 value (or a
    float64 reciprocal) rounded to float32 — as the Pallas kernels fold
    `jnp.float32(1.0 / x)`."""
    check_params(p)
    return {
        "dt": f32(p.dt), "v": f32(p.airspeed), "acc": f32(p.acc_lat_limit),
        "gx": f32(p.goal_x), "gy": f32(p.goal_y),
        "inv_max_steps": f32(1.0 / p.max_steps),
        "bearing": goal_bearing(p),
        "player_x0": f32(p.player_x0), "player_y0": f32(p.player_y0),
        "traffic_x0": f32(p.width - p.collision_radius),
        "traffic_y_top": f32(p.collision_radius),
        "traffic_y_span": f32(p.height - 2 * p.collision_radius),
        "player_lim": f32(p.player_initial_heading_lim),
        "traffic_lim": f32(p.traffic_initial_heading_lim),
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


# ------------------------------------------------------------- env math

def respawn(rb_psi, rb_sd, rb_tpsi, c: Dict[str, float]):
    """Respawn from three uniforms (game.py:84-106 distributions):
    (px, py, psi, tx, ty, tv, tpsi)."""
    psi = _mod360(c["bearing"] + (rb_psi * 2.0 - 1.0) * c["player_lim"])
    starts_down = (rb_sd < 0.5).to(torch.float32)
    t_y = c["traffic_y_top"] + starts_down * c["traffic_y_span"]
    t_psi = _mod360(145.0 + starts_down * 70.0
                    + (rb_tpsi * 2.0 - 1.0) * c["traffic_lim"])
    return (torch.full_like(psi, c["player_x0"]),
            torch.full_like(psi, c["player_y0"]), psi,
            torch.full_like(psi, c["traffic_x0"]), t_y,
            torch.full_like(psi, c["v"]), t_psi)


def env_geometry(px, py, cp, sp, psi, tx, ty, tv, tcos, tsin, a_lat,
                 c: Dict[str, float]):
    """Player/goal/traffic geometry with the bug_compat quirks
    (pallas_step.py:153-185): (d_goal, h_goal_rad, d_dev, d_sep, d_cpa,
    v_closing).  `a_lat` is the lateral acceleration the closing-speed
    lookahead assumes the player holds."""
    v, dt = c["v"], c["dt"]
    dxg = c["gx"] - px
    dyg = c["gy"] - py
    d_goal = torch.sqrt(dxg * dxg + dyg * dyg)
    h_goal_rad = _mod2pi(_atan2(dyg, dxg))
    d_dev = d_goal * torch.sin(h_goal_rad)
    dxt = tx - px
    dyt = ty - py
    d_sep = torch.sqrt(dxt * dxt + dyt * dyt)
    # signed closest-approach distance (kinematics.py:40-49, arctan quirk)
    v12x = v * cp - tv * tcos
    v12y = v * sp - tv * tsin
    h_rel = _atan(v12y / torch.where(v12x == 0.0, f32(1e-30), v12x))
    a_rel = _mod2pi(_atan2(dyt, dxt))
    d_cpa = d_sep * torch.sin(a_rel - h_rel)
    # closing speed via one-step lookahead (kinematics.py:52-79)
    psi1l = (psi + (a_lat / v) * dt) * DEG2RAD
    vx1 = v * torch.cos(psi1l) * dt
    vy1 = v * torch.sin(psi1l) * dt
    vx2 = tv * tcos * dt
    vy2 = v * tsin * dt                     # bug_compat: v (player) not tv
    dpx = (px + vx1) - (tx + vx2)
    dpy = (py + vy1) - (ty + tv * tsin * dt)
    nd = torch.sqrt(dpx * dpx + dpy * dpy)
    v_closing = (((vx1 - vx2) * dpx + (vy1 - vy2) * dpy) / nd) / dt
    return d_goal, h_goal_rad, d_dev, d_sep, d_cpa, v_closing


def shaped_step_reward(psi, h_goal_deg, d_goal, d_dev, d_cpa, v_closing,
                       c: Dict[str, float]):
    """step_reward_5 (rewards.py:5-60) as the kernels state it
    (pallas_step.py:188-202)."""
    def pow4(x):
        sq = x * x
        return sq * sq
    dh = torch.abs(psi - h_goal_deg)
    dh = torch.minimum(dh, 360.0 - dh)
    r_head = pow4(1.0 - dh * f32(1.0 / 180.0))
    r_cpa = torch.clamp(pow4(d_cpa * c["inv_safe"]), max=1.0)
    dev_frac = torch.abs(d_dev) * c["inv_dev_reward"]
    r_dev = torch.where(dev_frac > 1.0, 0.0,
                        torch.sqrt(torch.clamp(1.0 - dev_frac, min=0.0)))
    r_goal = torch.clamp(pow4(1.0 - d_goal * c["inv_goal_reward"]), max=1.0)
    return r_head * torch.where(v_closing <= 0, r_cpa * r_dev, r_goal)


def build_obs(steps, psi, d_goal, h_goal_rad, d_dev, d_sep, d_cpa, v_closing,
              c: Dict[str, float]) -> torch.Tensor:
    """envs/core.py:observe feature order, (B, 8)."""
    return torch.stack([
        steps.to(torch.float32) * c["inv_max_steps"],
        psi * f32(1.0 / 360.0),
        d_dev * c["inv_d_dev_max"],
        d_goal * c["inv_d_goal_max"],
        (h_goal_rad * f32(1.0 / DEG2RAD)) * f32(1.0 / 360.0),
        d_sep * c["inv_d_sep_max"],
        d_cpa * c["inv_d_cpa_max"],
        v_closing * c["inv_v_closing_max"],
    ], dim=-1)
