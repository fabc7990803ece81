"""The reference PPO iteration of an env batch split over W ranks, written
out plainly: what the ranks of `benchmark/drive_ranks.py` must add up to.

Rank r holds envs [r B / W, (r + 1) B / W) of the whole batch and rolls
them out with the iteration's seed plus r * SEED_STRIDE (the kernels'
env index restarts at 0 on every rank, so the seed is folded by rank:
JAX learner.py:190-193, the program's `parallel.mesh.fold_seed`).
Everything else is the whole batch's iteration of `reference/ppo.py`:
GAE per env, the batch in the single process's env order, each epoch's
block permutation from member 0's generator, and for every minibatch the
clipped PPO loss's gradient over all its rows (advantages normalised
over the whole minibatch), clipping and an Adam step.  W = 1 is
`ppo.iteration` itself.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ppo

SEED_STRIDE = 7919


def fold(seed: int, rank: int) -> int:
    """The rollout seed of rank `rank`: `seed` + rank * SEED_STRIDE,
    wrapped to int32."""
    return ((seed + rank * SEED_STRIDE + (1 << 31)) % (1 << 32)) - (1 << 31)


def rollout(cfg: ppo.Config, tr: ppo.Train, seed: int, world: int,
            fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """`ppo.rollout` of each rank's envs with its folded seed, the ranks'
    buffers put back together in env order.  Updates `tr.env` and
    `tr.obs`."""
    B = tr.obs.shape[0]
    n = B // world
    outs, envs, obs = [], [], []
    for r in range(world):
        rows = slice(r * n, (r + 1) * n)
        part = ppo.Train(params=tr.params, mu=tr.mu, nu=tr.nu,
                         count=tr.count,
                         env={k: v[rows] for k, v in tr.env.items()},
                         obs=tr.obs[rows], generators=tr.generators)
        outs.append(ppo.rollout(cfg, part, fold(seed, r), fault))
        envs.append(part.env)
        obs.append(part.obs)
    tr.env = {k: torch.cat([e[k] for e in envs]) for k in envs[0]}
    tr.obs = torch.cat(obs)
    # time-major (T, P, n, ...) buffers and (P, n) last values
    return {k: torch.cat([o[k] for o in outs], dim=1 if k == "last_values"
                         else 2) for k in outs[0]}


def iteration(cfg: ppo.Config, tr: ppo.Train, world: int,
              tf32: bool = False, fault: Optional[str] = None
              ) -> Dict[str, torch.Tensor]:
    """One PPO iteration of one policy whose envs are split over `world`
    ranks; as `ppo.iteration` (its `fault`s included), the mean loss over
    the minibatch steps, (1,)."""
    seed, perms = ppo.draw_inputs(cfg, tr.generators)
    with ppo.precision(tf32):
        buf = rollout(cfg, tr, seed, world, fault)
        T, P, B = buf["values"].shape
        adv, ret = ppo.gae(buf["rewards"].view(T, P * B),
                           buf["values"].view(T, P * B),
                           buf["dones"].view(T, P * B),
                           buf["last_values"].reshape(P * B),
                           cfg.gamma, cfg.gae_lambda)
        fields = (buf["obs"], buf["actions"][..., None],
                  buf["log_probs"][..., None], buf["values"][..., None],
                  adv.view(T, P, B, 1), ret.view(T, P, B, 1))
        del buf
        data = torch.cat([f.reshape(T, P, B, -1) for f in fields], -1)
        del fields
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
