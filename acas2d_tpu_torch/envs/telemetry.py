"""Trajectory telemetry: the reference's per-step record lists as stacked
tensors (counterpart of `acas2d_tpu/envs/telemetry.py`).

The reference game object appends ~20 telemetry lists while stepping
(game.py:43-75, 130-160, 227-243, 263-276), which the eval drivers harvest
into CSVs (testing_main.py:113-138).  Here an instrumented step returns the
same quantities as tensors, batched over envs like `envs/core.py`, with the
reference's exact (and quirky) recording phases:

  * player path: position AFTER the player's integration (game.py:228);
  * traffic paths: positions BEFORE the traffic integration (game.py:230-231
    run before the update loop at 244-245), so the spawn position appears
    twice at the head of the reference list;
  * d_sep record: player post-update vs traffic PRE-update (game.py:235);
  * reward-parameter and reward-component records: post-both-updates, with
    `r_step` storing the time-discounted reward WITHOUT terminal bonuses
    (game.py:261,276: the append happens before the bonus branches);
  * t=0 seed entries (game.py:130-160), where `r_step` is the RAW step
    reward (no tdf), from `initial_telemetry`.

`step_with_telemetry` runs `core.step` itself and takes every record from
the states before and after it.  JAX runs the rollouts as a `lax.scan`;
here they are a Python loop over steps whose records are stacked at the
end, on the tensors' device.  This is the analysis path (the eval
driver's episode CSV): training never computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams
from acas2d_tpu_torch.envs import core
from acas2d_tpu_torch.ops import kinematics as kin
from acas2d_tpu_torch.ops import rewards as rw
from acas2d_tpu_torch.types import EnvState


@dataclasses.dataclass
class Telemetry:
    """Per-step records over envs: (B,) fields, (B, max_traffic) traffic
    positions and (B, obs_dim) observations for one step; a rollout's
    gain a leading (T_steps,) axis."""
    px: torch.Tensor          # player position after integration (path)
    py: torch.Tensor
    tx: torch.Tensor          # traffic positions BEFORE their integration
    ty: torch.Tensor
    psi: torch.Tensor         # heading_record
    d_sep: torch.Tensor       # min separation, player-post vs traffic-pre
    a_lat: torch.Tensor       # a_lat_record
    d_path_inc: torch.Tensor  # per-step path-length increment
    # evaluate-phase records (post both integrations):
    d_goal: torch.Tensor
    delta_h_goal: torch.Tensor
    v_closing: torch.Tensor
    d_cpa: torch.Tensor
    d_dev: torch.Tensor
    r_d_goal: torch.Tensor
    r_h_goal: torch.Tensor
    r_d_cpa: torch.Tensor
    r_d_dev: torch.Tensor
    r_step: torch.Tensor      # tdf-discounted reward, NO terminal bonuses
    reward: torch.Tensor      # full reward (with bonuses): the env's return
    done: torch.Tensor
    outcome: torch.Tensor
    obs: torch.Tensor


def _eval_records(state: EnvState, params: EnvParams
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The quantities evaluate() records (game.py:249-276), and the raw
    step reward."""
    p = params
    phi = core._h_goal(state, p)
    v_c_all, d_cpa_all = core._pair_metrics(state, p)
    v_c, d_cpa = v_c_all[:, 0], d_cpa_all[:, 0]
    d_goal = core._d_goal(state, p)
    d_dev = core._plan_deviation(state, p)
    r_step_raw = rw.step_reward(v_c, state.ppsi, phi, d_cpa, d_goal, d_dev,
                                p.safe_distance, p.d_dev_max_reward,
                                p.d_goal_max_reward)
    recs = dict(
        d_goal=d_goal,
        delta_h_goal=kin.delta_heading(state.ppsi, phi),
        v_closing=v_c, d_cpa=d_cpa, d_dev=d_dev,
        r_d_goal=rw.goal_distance_reward(d_goal, p.d_goal_max_reward),
        r_h_goal=rw.heading_reward(state.ppsi, phi),
        r_d_cpa=rw.closest_approach_reward(v_c, d_cpa, p.safe_distance),
        r_d_dev=rw.plan_deviation_reward(d_dev, p.d_dev_max_reward),
    )
    return recs, r_step_raw


def _min_separation(state: EnvState, params: EnvParams) -> torch.Tensor:
    return torch.amin(core._separations(state, params), dim=-1)


def initial_telemetry(state: EnvState, params: EnvParams
                      ) -> Dict[str, torch.Tensor]:
    """t=0 seed records (game.py:130-160).  Note `r_step` here is the RAW
    step reward: the reference applies no tdf to the seed entry."""
    recs, r_step_raw = _eval_records(state, params)
    return dict(
        px=state.px, py=state.py, tx=state.tx, ty=state.ty,
        psi=state.ppsi, d_sep=_min_separation(state, params),
        a_lat=state.pa_lat, r_step=r_step_raw, **recs)


def step_with_telemetry(state: EnvState, action,
                        params: EnvParams = DEFAULT_PARAMS
                        ) -> Tuple[EnvState, Telemetry]:
    """core.step, with the reference's records taken from the states before
    and after it."""
    p = params
    new, out = core.step(state, action, p)
    # player after its integration, traffic before theirs (game.py:230-235)
    mid = new.replace(tx=state.tx, ty=state.ty)
    recs, r_step_raw = _eval_records(new, p)
    tdf = 1 - (new.steps.to(new.px.dtype) / p.max_steps)     # game.py:259-261
    tel = Telemetry(px=new.px, py=new.py, tx=state.tx, ty=state.ty,
                    psi=new.ppsi, d_sep=_min_separation(mid, p),
                    a_lat=new.pa_lat,
                    d_path_inc=kin.distance(state.px, state.py,
                                            new.px, new.py),  # game.py:239
                    r_step=r_step_raw * tdf, reward=out.reward,
                    done=out.done, outcome=out.outcome, obs=out.obs, **recs)
    return new, tel


def _stack(records: List[Telemetry]) -> Telemetry:
    return Telemetry(**{f.name: torch.stack([getattr(r, f.name)
                                             for r in records])
                        for f in dataclasses.fields(Telemetry)})


@torch.no_grad()
def rollout_telemetry(state: EnvState, actions: torch.Tensor,
                      params: EnvParams = DEFAULT_PARAMS
                      ) -> Tuple[EnvState, Telemetry]:
    """Replay (T_steps, B) actions, stacking full telemetry.  No
    auto-reset: the caller slices each env at its first done (as the
    reference drivers break their step loop, testing_main.py:82-108)."""
    records = []
    for a in actions:
        state, tel = step_with_telemetry(state, a, params)
        records.append(tel)
    return state, _stack(records)


@torch.no_grad()
def rollout_telemetry_policy(state: EnvState, obs: torch.Tensor,
                             n_steps: int,
                             policy_fn: Callable[[torch.Tensor], torch.Tensor],
                             params: EnvParams = DEFAULT_PARAMS
                             ) -> Tuple[EnvState, Telemetry]:
    """Greedy-policy telemetry rollout: policy_fn(obs (B, O)) -> (B,)
    actions, for n_steps steps."""
    records = []
    for _ in range(n_steps):
        state, tel = step_with_telemetry(state, policy_fn(obs), params)
        obs = tel.obs
        records.append(tel)
    return state, _stack(records)
