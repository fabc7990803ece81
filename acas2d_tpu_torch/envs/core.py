"""Batch-native functional core of the ACAS-2D environment (torch).

Counterpart of `acas2d_tpu/envs/core.py:101-301`.  The JAX package writes
these functions for one env and adds the batch axis with `vmap`; here every
function takes and returns `(B,)`-batched tensors directly:

    observe(state, params)                  -> (state, obs (B, O))
    spawn(n, params, generator)             -> state
    reset(n, params, generator)             -> (state, obs)
    reset_from(psi, tx, ty, tv, tpsi, nt)   -> (state, obs)   (Mersenne parity)
    step(state, action, params)             -> (state, StepOutput)
    step_autoreset(state, action, params, generator, fresh)
                                            -> same, terminated envs respawn
    spawn_from_uniforms(u, params)          -> state   (draws made elsewhere)

Reference semantics (parity contract of the JAX package):
  * step order: action -> integrate player, then traffic -> observe
    (steps += 1) -> evaluate -> termination check (environment.py:29-42);
  * observation layout and normalizers (game.py:194-218, 118-128);
  * shaped reward with time discount + terminal bonuses (game.py:249-292);
  * termination precedence timeout > collision > goal (game.py:294-314).
The obs is statically shaped at 5 + 3*max_traffic with zeros for absent
aircraft, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams
from acas2d_tpu_torch.ops import kinematics as kin
from acas2d_tpu_torch.ops import rewards as rw
from acas2d_tpu_torch.types import EnvState, StepOutput


# ------------------------------------------------------------------ helpers

def _traffic_mask(params: EnvParams, num_traffic) -> torch.Tensor:
    """(B, max_traffic) bool — True for active traffic slots."""
    slots = torch.arange(params.max_traffic, device=num_traffic.device)
    return slots[None, :] < num_traffic[:, None]


def _d_goal(state: EnvState, params: EnvParams):
    return kin.distance(state.px, state.py, params.goal_x, params.goal_y)


def _h_goal(state: EnvState, params: EnvParams):
    gx = torch.full_like(state.px, params.goal_x)
    gy = torch.full_like(state.py, params.goal_y)
    return kin.relative_angle(state.px, state.py, gx, gy)


def _plan_deviation(state: EnvState, params: EnvParams):
    """game.py:175-180: d_goal * sin(h_goal)."""
    d_goal = _d_goal(state, params)
    h_goal_rad = kin.deg_to_rad(_h_goal(state, params))
    return d_goal * torch.sin(h_goal_rad)


def _separations(state: EnvState, params: EnvParams):
    """(B, T) distances to all traffic; +inf for inert slots."""
    d = kin.distance(state.px[:, None], state.py[:, None], state.tx, state.ty)
    return torch.where(_traffic_mask(params, state.num_traffic), d,
                       float("inf"))


def _collision(state: EnvState, params: EnvParams):
    """game.py:185-189 — any active traffic within 2*COLLISION_RADIUS."""
    return torch.any(_separations(state, params)
                     < 2 * params.collision_radius, dim=-1)


def _goal_reached(state: EnvState, params: EnvParams):
    return _d_goal(state, params) < params.goal_radius        # game.py:191


def _pair_metrics(state: EnvState, params: EnvParams):
    """(v_closing, d_cpa) of the player vs every traffic slot, (B, T)."""
    px, py = state.px[:, None], state.py[:, None]
    ppsi = state.ppsi[:, None]
    v_c = kin.closing_speed(
        px, py, params.airspeed, ppsi, state.pa_lat[:, None],
        state.tx, state.ty, state.tv, state.tpsi, 0.0,
        params.dt, params.bug_compat)
    d_cpa = kin.distance_closest_approach(
        px, py, params.airspeed, ppsi,
        state.tx, state.ty, state.tv, state.tpsi, params.bug_compat)
    return v_c, d_cpa


# ------------------------------------------------------------------ observe

def observe(state: EnvState, params: EnvParams
            ) -> Tuple[EnvState, torch.Tensor]:
    """Normalized observation; increments the step counter first
    (game.py:194-218)."""
    state = state.replace(steps=state.steps + 1)
    dtype = state.px.dtype
    t_frac = state.steps.to(dtype) / params.max_steps
    d_sep = _separations(state, params)
    v_c, d_cpa = _pair_metrics(state, params)
    mask = _traffic_mask(params, state.num_traffic)
    per_traffic = torch.stack([
        torch.where(mask, d_sep / params.d_separation_max, 0.0),
        torch.where(mask, d_cpa / params.d_cpa_max, 0.0),
        torch.where(mask, v_c / params.v_closing_max, 0.0),
    ], dim=-1)                                     # (B, T, 3)
    head = torch.stack([
        t_frac,
        state.ppsi / 360,
        _plan_deviation(state, params) / params.d_dev_max,
        _d_goal(state, params) / params.d_goal_max,
        _h_goal(state, params) / 360,
    ], dim=-1)                                     # (B, 5)
    obs = torch.cat([head, per_traffic.reshape(per_traffic.shape[0], -1)],
                    dim=-1).to(dtype)
    return state, obs


# -------------------------------------------------------------------- spawn

def _uniform(generator: torch.Generator, shape, lo: float, hi: float):
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    return lo + (hi - lo) * u


def spawn_width(params: EnvParams) -> int:
    """Uniforms one spawn takes (`spawn_from_uniforms`): the traffic count,
    the player's heading jitter, slot 0's corner, speed and heading jitter,
    and x, y, speed and heading of each further slot."""
    return 5 + 4 * (params.max_traffic - 1)


def _goal_bearing(p: EnvParams) -> float:
    return kin.relative_angle(
        torch.tensor(p.player_x0, dtype=torch.float64),
        torch.tensor(p.player_y0, dtype=torch.float64),
        torch.tensor(p.goal_x, dtype=torch.float64),
        torch.tensor(p.goal_y, dtype=torch.float64)).item()


def _spawned(p: EnvParams, num_traffic, u_psi, starts_down, u_v0, u_h0,
             u_rest, dtype, device) -> EnvState:
    """The spawn of game.py:41,88-114 from its draws: the traffic count
    (int), slot 0's corner (0. or 1.), float64 uniforms in [0, 1) of the
    player's heading jitter and slot 0's speed and heading jitter (n,)
    each, and x, y, speed and heading of the further slots (4, n,
    max_traffic - 1), or None for one slot."""
    n = num_traffic.shape[0]
    lim = p.player_initial_heading_lim
    ppsi = torch.remainder(_goal_bearing(p) + (-lim + 2 * lim * u_psi), 360)

    def scaled(u, lo, hi):
        return lo + (hi - lo) * u

    # Traffic slot 0 (game.py:98-106): right edge, top or bottom corner.
    t0x = torch.full((n,), p.width - p.collision_radius,
                     dtype=torch.float64, device=starts_down.device)
    t0y = p.collision_radius + starts_down * (p.height - 2 * p.collision_radius)
    t0v = scaled(u_v0, p.airspeed_factor_min,
                 p.airspeed_factor_max) * p.airspeed
    tlim = p.traffic_initial_heading_lim
    t0psi = torch.remainder(145 + starts_down * 70 + scaled(u_h0, -tlim, tlim),
                            360)
    tx, ty, tv, tpsi = (t0x[:, None], t0y[:, None], t0v[:, None],
                        t0psi[:, None])
    if u_rest is not None:
        # Slots >= 1 (game.py:107-114): uniform over the upper airspace.
        rx, ry, rv, rpsi = u_rest
        tx = torch.cat([tx, scaled(rx, 0.0, p.width - p.aircraft_size)], 1)
        ty = torch.cat([ty, scaled(ry, 0.0, 3 * p.height / 5)], 1)
        tv = torch.cat([tv, scaled(rv, p.airspeed_factor_min,
                                   p.airspeed_factor_max) * p.airspeed], 1)
        tpsi = torch.cat([tpsi, scaled(rpsi, 0.0, 360.0)], 1)

    def f(x):
        return x.to(device=device, dtype=dtype)

    zeros = torch.zeros(n, dtype=dtype, device=device)
    zeros_i = torch.zeros(n, dtype=torch.int32, device=device)
    return EnvState(
        px=torch.full((n,), p.player_x0, dtype=dtype, device=device),
        py=torch.full((n,), p.player_y0, dtype=dtype, device=device),
        ppsi=f(ppsi), pa_lat=zeros,
        tx=f(tx), ty=f(ty), tv=f(tv), tpsi=f(tpsi),
        num_traffic=num_traffic.to(device=device, dtype=torch.int32),
        steps=zeros_i, total_reward=zeros.clone(), outcome=zeros_i.clone())


def spawn(n: int, params: EnvParams = DEFAULT_PARAMS,
          generator: Optional[torch.Generator] = None,
          dtype=torch.float32, device=None) -> EnvState:
    """Spawn n episodes with draws from `generator` on `device` (default
    CUDA; see `acas2d_tpu_torch.resolve_device`).

    The distributions of the reference spawn (game.py:41,88-114), as
    `acas2d_tpu.envs.core.spawn` draws them with threefry; the bits differ.
    Exact reference streams are `oracle.MersenneSpawner` + `reset_from`.
    """
    p = params
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator()
    num_traffic = torch.randint(p.min_traffic, p.max_traffic + 1, (n,),
                                generator=g, device=g.device)
    u_psi = _uniform(g, (n,), 0.0, 1.0)
    starts_down = torch.randint(0, 2, (n,), generator=g,
                                device=g.device).to(torch.float64)
    u_v0 = _uniform(g, (n,), 0.0, 1.0)
    u_h0 = _uniform(g, (n,), 0.0, 1.0)
    rest = (n, p.max_traffic - 1)
    u_rest = ([_uniform(g, rest, 0.0, 1.0) for _ in range(4)]
              if p.max_traffic > 1 else None)
    return _spawned(p, num_traffic, u_psi, starts_down, u_v0, u_h0, u_rest,
                    dtype, device)


def spawn_from_uniforms(u: torch.Tensor, params: EnvParams = DEFAULT_PARAMS,
                        dtype=torch.float32) -> EnvState:
    """Spawn u.shape[0] episodes from (n, `spawn_width`) uniforms in [0, 1)
    on their device: the spawn distributions of `spawn`, each draw taken
    from its own column (the traffic count and slot 0's corner by
    thresholds).  The unfused rollout's respawns (`step_autoreset`'s
    `fresh`) come from uniforms drawn on the card."""
    p = params
    u = u.to(torch.float64)
    span = p.max_traffic - p.min_traffic + 1
    num_traffic = torch.clamp(p.min_traffic + torch.floor(u[:, 0] * span),
                              max=p.max_traffic).to(torch.int32)
    starts_down = (u[:, 2] < 0.5).to(torch.float64)
    u_rest = (u[:, 5:].reshape(-1, 4, p.max_traffic - 1).unbind(1)
              if p.max_traffic > 1 else None)
    return _spawned(p, num_traffic, u[:, 1], starts_down, u[:, 3], u[:, 4],
                    u_rest, dtype, u.device)


def reset(n: int, params: EnvParams = DEFAULT_PARAMS,
          generator: Optional[torch.Generator] = None,
          dtype=torch.float32, device=None) -> Tuple[EnvState, torch.Tensor]:
    """Fresh episodes + initial observations (environment.py:44-48: the
    reference builds the game then observes once, so steps becomes 1)."""
    return observe(spawn(n, params, generator, dtype, device), params)


def reset_from(player_psi, traffic_x, traffic_y, traffic_v, traffic_psi,
               num_traffic, params: EnvParams = DEFAULT_PARAMS,
               dtype=torch.float64, device=None
               ) -> Tuple[EnvState, torch.Tensor]:
    """Reset from externally drawn spawn values: player_psi and num_traffic
    (B,), traffic fields (B, max_traffic) — the host Mersenne parity path
    (see oracle.MersenneSpawner for the draw-order contract)."""
    p = params
    device = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    psi = f(player_psi)
    n = psi.shape[0]
    zeros = torch.zeros(n, dtype=dtype, device=device)
    zeros_i = torch.zeros(n, dtype=torch.int32, device=device)
    state = EnvState(
        px=torch.full((n,), p.player_x0, dtype=dtype, device=device),
        py=torch.full((n,), p.player_y0, dtype=dtype, device=device),
        ppsi=psi, pa_lat=zeros,
        tx=f(traffic_x), ty=f(traffic_y), tv=f(traffic_v),
        tpsi=f(traffic_psi),
        num_traffic=torch.as_tensor(np.asarray(num_traffic),
                                    dtype=torch.int32, device=device),
        steps=zeros_i, total_reward=zeros.clone(), outcome=zeros_i.clone())
    return observe(state, params)


# --------------------------------------------------------------------- step

def step(state: EnvState, action, params: EnvParams = DEFAULT_PARAMS
         ) -> Tuple[EnvState, StepOutput]:
    """One transition (environment.py:29-42 without the clock).  `action`
    (B,) in [-1, 1] is rescaled to a lateral acceleration (game.py:222-225)."""
    p = params
    dtype = state.px.dtype
    a_lat = torch.as_tensor(action, dtype=dtype,
                            device=state.px.device) * p.acc_lat_limit
    a_lat = a_lat.expand_as(state.px)

    # action phase (game.py:222-247): player first, traffic (a_lat 0) after
    px, py, ppsi = kin.integrate(state.px, state.py, p.airspeed, state.ppsi,
                                 a_lat, p.dt)
    ntx, nty, ntpsi = kin.integrate(state.tx, state.ty, state.tv, state.tpsi,
                                    torch.zeros_like(state.tx), p.dt)
    mask = _traffic_mask(p, state.num_traffic)
    state = state.replace(
        px=px, py=py, ppsi=ppsi, pa_lat=a_lat,
        tx=torch.where(mask, ntx, state.tx),
        ty=torch.where(mask, nty, state.ty),
        tpsi=torch.where(mask, ntpsi, state.tpsi))

    # observe phase (environment.py:35): increments the step counter
    state, obs = observe(state, p)

    # evaluate phase (game.py:249-292)
    phi = _h_goal(state, p)
    v_c_all, d_cpa_all = _pair_metrics(state, p)
    v_c, d_cpa = v_c_all[:, 0], d_cpa_all[:, 0]   # slot 0 only, game.py:254-255
    d_goal = _d_goal(state, p)
    d_dev = _plan_deviation(state, p)
    r_step = rw.step_reward(v_c, state.ppsi, phi, d_cpa, d_goal, d_dev,
                            p.safe_distance, p.d_dev_max_reward,
                            p.d_goal_max_reward)
    tdf = 1 - (state.steps.to(dtype) / p.max_steps)
    collided = _collision(state, p)
    at_goal = _goal_reached(state, p)
    reward = (r_step * tdf
              + torch.where(collided, p.reward_collision, 0.0)
              + torch.where(at_goal, p.reward_goal, 0.0)).to(dtype)
    total_reward = state.total_reward + reward

    # termination (game.py:294-314): timeout > collision > goal
    outcome = torch.where(
        state.steps > p.max_steps, 3,
        torch.where(collided, 2, torch.where(at_goal, 1, 0))
    ).to(torch.int32)
    done = outcome != 0

    state = state.replace(total_reward=total_reward, outcome=outcome)
    out = StepOutput(
        obs=obs, reward=reward, done=done, outcome=outcome,
        episode_steps=torch.where(done, state.steps, 0),
        episode_return=torch.where(done, total_reward, 0.0))
    return state, out


def step_autoreset(state: EnvState, action, params: EnvParams = DEFAULT_PARAMS,
                   generator: Optional[torch.Generator] = None,
                   fresh: Optional[Tuple[EnvState, torch.Tensor]] = None
                   ) -> Tuple[EnvState, StepOutput]:
    """step() with masked auto-reset (SB3 DummyVecEnv semantics): a
    terminated env respawns at once, and its returned obs is the reset
    observation; reward/done/outcome describe the terminated episode.
    The respawns are `fresh`, a reset batch (state, obs) made beforehand,
    else drawn from `generator`."""
    stepped, out = step(state, action, params)
    if fresh is None:
        fresh = reset(state.px.shape[0], params, generator,
                      dtype=state.px.dtype, device=state.px.device)
    fresh, fresh_obs = fresh
    next_state = fresh.select(out.done, stepped)
    out = out.replace(obs=torch.where(out.done[:, None], fresh_obs, out.obs))
    return next_state, out
