"""The env-only rollout and the greedy eval, written out plainly: the
benchmark's reference for the `envstep` traffic and for the evals of the
`attempt` traffic.

  * `env_rollout`: T autoreset steps of B envs on the kernels' statement
    of the env, under uniform random actions from the hash RNG (salt 0)
    and respawns on salts 1-3; returns the final state and each env's sums
    of rewards, episodes ended, goals, collisions and, one feature at a
    time, its eight observation features after every step.
  * `greedy_eval`: P members, each on its own episodes of the engine's
    statement of the env, taking the clipped mean action for up to
    max_steps steps; each env's first episode gives its return, length
    and outcome.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import envmath as em
from .ppo import forward

STATE = ("px", "py", "psi", "tx", "ty", "tv", "tpsi", "steps", "total")


@torch.no_grad()
def env_rollout(st: Dict[str, torch.Tensor], seed: int, T: int,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """`st` holds STATE's (B,) fields (steps int32); the floats are taken
    in `dtype`.  Returns the final STATE and the sums reward_sum,
    episodes, goals, collisions, obs_sum."""
    c = em.constants()
    f = {k: (v if k == "steps" else v.to(dtype)) for k, v in st.items()}
    env = em.KernelEnv(f, f["steps"], f["total"], c, em.ENV.max_steps)
    B = f["px"].shape[0]
    base = em.rng_base(seed, B, f["px"].device)
    rs = torch.zeros(B, dtype=dtype, device=f["px"].device)
    os_ = torch.zeros_like(rs)
    ec = torch.zeros(B, dtype=torch.int32, device=rs.device)
    gc, cc = torch.zeros_like(ec), torch.zeros_like(ec)
    for i in range(T):
        a_lat = ((em.uniform(base, i, 0) * 2.0 - 1.0) * c["acc"]).to(dtype)
        reward, done, _, collided, at_goal, in_time = env.advance(a_lat)
        rs = rs + reward
        ec = ec + done.to(torch.int32)
        gc = gc + (at_goal & ~collided & in_time).to(torch.int32)
        cc = cc + (collided & in_time).to(torch.int32)
        env.respawn(done, base, i)
        for feat in env.observe(torch.where(done, 0.0, a_lat)).unbind(-1):
            os_ = os_ + feat
    out = {k: getattr(env, k) for k in STATE[:7]}
    out.update(steps=env.steps, total=env.total, reward_sum=rs, episodes=ec,
               goals=gc, collisions=cc, obs_sum=os_)
    return out


@torch.no_grad()
def greedy_eval(params: torch.Tensor, generator: torch.Generator,
                episodes: int, device) -> Dict[str, torch.Tensor]:
    """P members' greedy episodes on spawns drawn from `generator` (member
    m on the m-th run of `episodes` of them): per-member return mean and
    std (ddof 0), mean length, goal and collision rates, (P,) each."""
    P = params.shape[0]
    n = P * episodes
    s, obs = em.observe(em.spawn_generator(n, generator, torch.float32,
                                           device))
    ret = torch.zeros(n, device=device)
    length = torch.zeros(n, dtype=torch.int32, device=device)
    outcome = torch.zeros(n, dtype=torch.int32, device=device)
    seen = torch.zeros(n, dtype=torch.bool, device=device)
    for _ in range(em.ENV.max_steps):
        mean = forward(params, obs.view(P, episodes, -1))[0].reshape(n)
        s, obs, reward, out = em.step(s, torch.clamp(mean, -1.0, 1.0))
        done = out != 0
        active = ~seen
        ret = ret + torch.where(active, reward, 0.0)
        length = length + active.to(torch.int32)
        outcome = torch.where(active & done, out, outcome)
        seen = seen | done
    ret, length, outcome = (x.view(P, episodes) for x in (ret, length,
                                                          outcome))
    return {"eval_return_mean": ret.mean(-1),
            "eval_return_std": ret.std(-1, correction=0),
            "eval_length_mean": length.to(torch.float32).mean(-1),
            "eval_goal_rate": (outcome == 1).to(torch.float32).mean(-1),
            "eval_collision_rate": (outcome == 2).to(torch.float32).mean(-1)}
