"""The unfused PPO iteration written out plainly: the benchmark's reference
for the `reference` configuration, the program's default training path
(both fused flags off), frozen here so that later changes to the program
cannot move it.

It differs from `ppo.py` in the rollout alone.  The envs are stepped as
the engine states the step (`envmath.step`, `observe`, `spawn_uniforms`),
with torch's own arctan, not as the kernels state it.  Each step takes
the policy's Gaussian sample, whose standard normal noise is the hash
RNG's Box-Muller on salts 4 and 5 (the kernels' noise), and its log-prob
by SB3's density; the engine's step of the action clipped to [-1, 1];
and where an episode ended, a respawn from five hash uniforms of that
step, on salts 8 to 12 (the traffic count, the heading jitter, the
corner, the speed factor, the traffic's heading jitter), with its first
observation.  The draws and the respawns of every step are made before
the steps, each element as its step would make it.  The rest is
`ppo.py`'s: GAE(0.99, 0.95), each epoch's permutation of blocks of
`Config.block` rows (1 row, SB3's shuffle, at the published minibatch of
64) from the member's generator, and for every minibatch the clipped
loss's gradient by autograd, clipping by its global norm and an Adam
step with optax's arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from . import envmath as em
from . import ppo

NOISE_SALTS = (4, 5)
SPAWN_SALT = 8
SPAWN_WIDTH = 5        # uniforms a spawn takes, one traffic aircraft


def start(params: torch.Tensor, u: torch.Tensor,
          generators: Sequence[torch.Generator]) -> ppo.Train:
    """The training state from the benchmark's inputs, as `ppo.start`
    makes it, but with the engine's state (`envmath.State`) as its envs."""
    s, obs = em.observe(em.spawn_uniforms(u))
    return ppo.Train(params=params.clone(), mu=torch.zeros_like(params),
                     nu=torch.zeros_like(params), count=0, env=s, obs=obs,
                     generators=list(generators))


def _select(done: torch.Tensor, a: em.State, b: em.State) -> em.State:
    """Each field of `a` where `done`, else of `b`."""
    return em.State(**{f.name: torch.where(done, getattr(a, f.name),
                                           getattr(b, f.name))
                       for f in dataclasses.fields(em.State)})


@torch.no_grad()
def rollout(cfg: ppo.Config, tr: ppo.Train, seed: int,
            fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """n_steps autoreset steps of every member on its envs, on the engine's
    statement.  Updates `tr.env` and `tr.obs`; returns time-major buffers
    (T, P, B) and the last values (P, B)."""
    P = tr.params.shape[0]
    PB = tr.obs.shape[0]
    B = PB // P
    dev = tr.obs.device
    ls = torch.clamp(tr.params[:, -1], -4.0, 2.0).repeat_interleave(B)
    T = cfg.n_steps
    # every step's draws: (T, PB) uniforms of step t, env e, each salt
    base = em.rng_base(seed, PB, dev)[None, :]
    steps = torch.arange(T, device=dev, dtype=torch.int64)[:, None]
    u1, u2 = (em.uniform(base, steps, k) for k in NOISE_SALTS)
    noise = (torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u1,
                                                     min=em.f32(1e-12))))
             * torch.cos(em.TWO_PI * u2))
    spawns, spawn_obs = em.observe(em.spawn_uniforms(torch.stack(
        [em.uniform(base, steps, SPAWN_SALT + j) for j in range(SPAWN_WIDTH)],
        dim=-1).view(T * PB, SPAWN_WIDTH)))
    s, obs = tr.env, tr.obs
    bufs: Dict[str, List[torch.Tensor]] = {}
    for t in range(T):
        mean, value = ppo.forward(tr.params, obs.view(P, B, ppo.OBS))
        mean, value = mean.reshape(PB), value.reshape(PB)
        action = mean + torch.exp(ls) * noise[t]
        logp = -0.5 * ((action - mean) ** 2 / torch.exp(2 * ls) + 2 * ls
                       + ppo.LOG_2PI)
        s, next_obs, reward, outcome = em.step(s, torch.clamp(action, -1.0,
                                                              1.0))
        if fault == "reward":
            reward = reward + 1.0
        done = outcome != 0
        step = dict(obs=obs, actions=action, log_probs=logp, values=value,
                    rewards=reward, dones=done,
                    episode_return=torch.where(done, s.total, 0.0),
                    episode_steps=torch.where(done, s.steps, 0),
                    outcome=outcome)
        for k, v in step.items():
            bufs.setdefault(k, []).append(v)
        rows = slice(t * PB, (t + 1) * PB)
        fresh = em.State(**{f.name: getattr(spawns, f.name)[rows]
                            for f in dataclasses.fields(em.State)})
        s = _select(done, fresh, s)
        obs = torch.where(done[:, None], spawn_obs[rows], next_obs)
    out = {k: torch.stack(v).view(T, P, B, *v[0].shape[1:])
           for k, v in bufs.items()}
    out["last_values"] = ppo.forward(tr.params, obs.view(P, B, ppo.OBS))[1]
    tr.env, tr.obs = s, obs
    return out


def iteration(cfg: ppo.Config, tr: ppo.Train, tf32: bool = False,
              fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """One PPO iteration of every member (`ppo.iteration` on this
    rollout); returns the per-member means over its minibatch steps of the
    loss, (P,).  `fault` plants `ppo.iteration`'s faults: "half" takes
    each minibatch's gradient over its first half of rows, "reward" adds
    1 to every reward as it is produced."""
    seed, perms = ppo.draw_inputs(cfg, tr.generators)
    with ppo.precision(tf32):
        buf = rollout(cfg, tr, seed, fault)
        T, P, B = buf["values"].shape
        adv, ret = ppo.gae(buf["rewards"].view(T, P * B),
                           buf["values"].view(T, P * B),
                           buf["dones"].view(T, P * B),
                           buf["last_values"].reshape(P * B),
                           cfg.gamma, cfg.gae_lambda)
        fields = (buf["obs"], buf["actions"], buf["log_probs"],
                  buf["values"], adv.view(T, P, B), ret.view(T, P, B))
        data = torch.cat([f.reshape(T, P, B, -1) for f in fields], -1)
        data = data.transpose(0, 1).reshape(P, T * B, 13)
        blocks = data.view(P, T * B // cfg.block, cfg.block, 13)
        members = torch.arange(P, device=data.device)[:, None]
        losses = []
        for e in range(cfg.n_epochs):
            mbs = blocks[members, perms[e].to(data.device)].view(
                P, cfg.n_minibatches, cfg.minibatch, 13)
            for j in range(cfg.n_minibatches):
                mb = mbs[:, j]
                if fault == "half":
                    mb = mb[:, :cfg.minibatch // 2]
                loss, grads = ppo.loss_and_grads(cfg, tr.params, mb)
                ppo.adam(cfg, tr, grads)
                losses.append(loss)
    return {"loss": torch.stack(losses, -1).mean(-1)}
