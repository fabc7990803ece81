"""PPO on ACAS-2D written out plainly: the benchmark's reference for the
training cells, frozen here so that later changes to the program cannot
move it.

The policy is SB3's default `MlpPolicy` for a one-dimensional action:
separate pi and vf towers of Linear(64)-tanh-Linear(64)-tanh, a linear
head each, and a state-independent log-std clamped to [-4, 2] with a
straight-through gradient.  The parameters of P members are one (P,
9603) float32 matrix whose columns are laid out tower by tower (W1 (64,
8), b1, W2 (64, 64), b2, head weight (64,), head bias), pi then vf, and
log_std last: the layout in which the program takes and returns them.

An iteration is SB3's PPO with the program's documented choices: the
rollout of `n_steps` autoreset steps on the kernels' statement of the env
with the hash RNG (action noise by Box-Muller on salts 4 and 5, respawns
on salts 1-3, one seed an iteration drawn from member 0's generator),
GAE(0.99, 0.95), `n_epochs` epochs that permute each member's blocks of
`shuffle_block` rows from its own generator, and for every minibatch
the clipped PPO loss's gradient by autograd, clipping by its global norm
and an Adam step with optax's arithmetic.  Products run in float32
unless `tf32` asks for TF32 (the control).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import envmath as em

HIDDEN, OBS = 64, 8
LAYOUT = (("w1", (HIDDEN, OBS)), ("b1", (HIDDEN,)), ("w2", (HIDDEN, HIDDEN)),
          ("b2", (HIDDEN,)), ("wh", (HIDDEN,)), ("bh", (1,)))
LEAVES = tuple(f"{t}.{n}" for t in ("pi", "vf") for n, _ in LAYOUT) + (
    "log_std",)
N_PARAMS = 2 * sum(math.prod(s) for _, s in LAYOUT) + 1
INT32_MAX = 2 ** 31 - 1
LOG_2PI = math.log(2.0 * math.pi)


def leaves(params: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Views of (..., N_PARAMS) parameters by leaf name."""
    out, i = {}, 0
    for tower in ("pi", "vf"):
        for name, shape in LAYOUT:
            n = math.prod(shape)
            out[f"{tower}.{name}"] = params[..., i:i + n].unflatten(-1, shape)
            i += n
    out["log_std"] = params[..., i:i + 1]
    return out


def init_params(P: int, generator: torch.Generator, device
                ) -> torch.Tensor:
    """SB3's initialisation of P policies, made on the device: orthogonal
    weights (gain sqrt 2 in the towers, 0.01 for the action head, 1 for
    the value head), zero biases, log_std 0.  Each weight is the Q of a
    QR of a Gaussian matrix, its columns' signs fixed by R's diagonal."""
    def orth(rows, cols, gain):
        a = torch.randn(P, max(rows, cols), min(rows, cols),
                        generator=generator, device=device)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
        if rows < cols:
            q = q.transpose(1, 2)
        return (gain * q).reshape(P, -1)

    parts = []
    for tower, head_gain in (("pi", 0.01), ("vf", 1.0)):
        parts += [orth(HIDDEN, OBS, math.sqrt(2.0)),
                  torch.zeros(P, HIDDEN, device=device),
                  orth(HIDDEN, HIDDEN, math.sqrt(2.0)),
                  torch.zeros(P, HIDDEN, device=device),
                  orth(1, HIDDEN, head_gain),
                  torch.zeros(P, 1, device=device)]
    parts.append(torch.zeros(P, 1, device=device))
    return torch.cat(parts, dim=1).contiguous()


def forward(params: torch.Tensor, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(action mean, value) of P members, each on its rows: params (P,
    N_PARAMS), x (P, n, 8) -> (P, n) each."""
    lv = leaves(params)
    out = []
    for t in ("pi", "vf"):
        h1 = torch.tanh(torch.baddbmm(lv[f"{t}.b1"][:, None], x,
                                      lv[f"{t}.w1"].transpose(1, 2)))
        h2 = torch.tanh(torch.baddbmm(lv[f"{t}.b2"][:, None], h1,
                                      lv[f"{t}.w2"].transpose(1, 2)))
        out.append(torch.bmm(h2, lv[f"{t}.wh"][..., None])[..., 0]
                   + lv[f"{t}.bh"])
    return out[0], out[1]


def log_std(params: torch.Tensor) -> torch.Tensor:
    """(P,) log-std, clamped forward, straight through backward."""
    ls = params[:, -1]
    return ls + (torch.clamp(ls, -4.0, 2.0) - ls).detach()


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in float32 (TF32 off) or, for the control, in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclasses.dataclass
class Config:
    """The PPO settings an iteration needs."""
    n_envs: int
    n_steps: int
    minibatch: int
    n_epochs: int = 10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    lr: float = 3e-4
    adam_eps: float = 1e-5
    anneal_lr: bool = False
    total_timesteps: int = 0
    chunk: int = 16

    @property
    def batch(self):
        return self.n_envs * self.n_steps

    @property
    def block(self):
        b = 512 if self.minibatch >= 1 << 15 and self.minibatch % 512 == 0 \
            else 1
        return b

    @property
    def n_minibatches(self):
        return self.batch // self.minibatch

    @property
    def total_updates(self):
        return ((self.total_timesteps // self.batch) * self.n_epochs
                * self.n_minibatches if self.anneal_lr else 0)


@dataclasses.dataclass
class Train:
    """P members' training state: params and Adam moments (P, N_PARAMS),
    the Adam count, the envs (kernel statement, P * B of them, member
    major), the observations (P * B, 8) and one host generator a member."""
    params: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    count: int
    env: Dict[str, torch.Tensor]
    obs: torch.Tensor
    generators: List[torch.Generator]


def start(params: torch.Tensor, u: torch.Tensor,
          generators: Sequence[torch.Generator]) -> Train:
    """The training state from the benchmark's inputs: params (P,
    N_PARAMS), spawn uniforms (P * B, 5) and the members' generators.
    The first observation is the engine's."""
    s, obs = em.observe(em.spawn_uniforms(u))
    env = dict(px=s.px, py=s.py, psi=s.psi, tx=s.tx, ty=s.ty, tv=s.tv,
               tpsi=s.tpsi, steps=s.steps.to(torch.int32), total=s.total)
    return Train(params=params.clone(), mu=torch.zeros_like(params),
                 nu=torch.zeros_like(params), count=0, env=env, obs=obs,
                 generators=list(generators))


def draw_inputs(cfg: Config, gens: Sequence[torch.Generator]
                ) -> Tuple[int, torch.Tensor]:
    """One iteration's draws, in the program's order: the rollout seed from
    member 0's generator, then each epoch's block permutation of every
    member from its own: (seed, perms (E, P, n_blocks))."""
    seed = int(torch.randint(0, INT32_MAX, (), generator=gens[0]))
    seed = ((seed + (1 << 31)) % (1 << 32)) - (1 << 31)
    n_blocks = cfg.batch // cfg.block
    perms = torch.stack([torch.stack([torch.randperm(n_blocks, generator=g)
                                      for g in gens])
                         for _ in range(cfg.n_epochs)])
    return seed, perms


@torch.no_grad()
def rollout(cfg: Config, tr: Train, seed: int, fault: Optional[str] = None
            ) -> Dict[str, torch.Tensor]:
    """n_steps autoreset steps of every member on its envs, with the
    kernels' statement of the env.  Updates `tr.env` and `tr.obs`; returns
    time-major buffers (T, P, B, ...) and the last values (P, B)."""
    c = em.constants()
    P = tr.params.shape[0]
    PB = tr.obs.shape[0]
    B = PB // P
    dev = tr.obs.device
    ls = torch.clamp(tr.params[:, -1], -4.0, 2.0).repeat_interleave(B)
    sigma = torch.exp(ls)
    logp_const = -ls - c["half_log_2pi"]
    base = em.rng_base(seed, PB, dev)
    env = em.KernelEnv(tr.env, tr.env["steps"], tr.env["total"], c, 1000)
    obs = tr.obs
    bufs: Dict[str, List[torch.Tensor]] = {}
    for t in range(cfg.n_steps):
        mean, value = forward(tr.params, obs.view(P, B, OBS))
        mean, value = mean.reshape(PB), value.reshape(PB)
        u1, u2 = em.uniform(base, t, 4), em.uniform(base, t, 5)
        z = (torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u1,
                                                     min=em.f32(1e-12))))
             * torch.cos(em.TWO_PI * u2))
        action = mean + sigma * z
        dz = (action - mean) / sigma
        logp = logp_const - 0.5 * dz * dz
        a_lat = torch.clamp(action, -1.0, 1.0) * c["acc"]
        reward, done, outcome, _, _, _ = env.advance(a_lat)
        if fault == "reward":
            reward = reward + 1.0
        ep_ret = torch.where(done, env.total, 0.0)
        ep_len = torch.where(done, env.steps, 0)
        step = dict(obs=obs, actions=action, log_probs=logp, values=value,
                    rewards=reward, dones=done, episode_return=ep_ret,
                    episode_steps=ep_len, outcome=outcome)
        for k, v in step.items():
            bufs.setdefault(k, []).append(v)
        env.respawn(done, base, t)
        obs = env.observe(torch.where(done, 0.0, a_lat))
    out = {k: torch.stack(v).view(cfg.n_steps, P, B, *v[0].shape[1:])
           for k, v in bufs.items()}
    out["last_values"] = forward(tr.params, obs.view(P, B, OBS))[1]
    tr.env = dict(px=env.px, py=env.py, psi=env.psi, tx=env.tx, ty=env.ty,
                  tv=env.tv, tpsi=env.tpsi, steps=env.steps, total=env.total)
    tr.obs = obs
    return out


def gae(rewards, values, dones, last_value, gamma, lam):
    """GAE over time-major (T, N) inputs; returns (advantages, returns)."""
    not_done = 1.0 - dones.to(values.dtype)
    adv = torch.empty_like(values)
    g = torch.zeros_like(last_value)
    nxt = last_value
    for t in range(values.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * nxt * not_done[t] - values[t]
        g = delta + gamma * lam * not_done[t] * g
        adv[t] = g
        nxt = values[t]
    return adv, adv + values


def loss_and_grads(cfg: Config, params: torch.Tensor, mb: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each member's clipped PPO loss on its minibatch and its gradient by
    autograd: params (P, N_PARAMS), mb (P, M, 13) of obs, raw action, old
    log-prob, old value, advantage, return -> (loss (P,), grads)."""
    with torch.enable_grad():
        p = params.detach().requires_grad_(True)
        obs, act, old_logp = mb[..., :8], mb[..., 8], mb[..., 9]
        adv, ret = mb[..., 11], mb[..., 12]
        mean, value = forward(p, obs)
        ls = log_std(p)[:, None]
        logp = -0.5 * ((act - mean) ** 2 / torch.exp(2 * ls) + 2 * ls
                       + LOG_2PI)
        ratio = torch.exp(torch.clamp(logp - old_logp, -20.0, 20.0))
        adv = ((adv - adv.mean(-1, keepdim=True))
               / (adv.std(-1, correction=0, keepdim=True) + 1e-8))
        pl = -torch.minimum(adv * ratio, adv * torch.clamp(
            ratio, 1 - cfg.clip, 1 + cfg.clip)).mean(-1)
        vl = ((ret - value) ** 2).mean(-1)
        ent = 0.5 * (1.0 + LOG_2PI) + ls[:, 0]
        loss = pl - cfg.ent_coef * ent + cfg.vf_coef * vl
        grads, = torch.autograd.grad(loss.sum(), p)
    return loss.detach(), grads


def adam(cfg: Config, tr: Train, grads: torch.Tensor) -> torch.Tensor:
    """Clip each member's gradient by its global norm, then one Adam step
    with optax's arithmetic; returns the clipped gradient."""
    b1, b2 = 0.9, 0.999
    c = tr.count + 1
    frac = (1.0 - min(tr.count, cfg.total_updates) / cfg.total_updates
            if cfg.total_updates else 1.0)
    dt = tr.params.dtype
    bc1 = torch.tensor(1 - b1 ** c, dtype=torch.float64).to(dt).to(grads.device)
    bc2 = torch.tensor(1 - b2 ** c, dtype=torch.float64).to(dt).to(grads.device)
    step = torch.tensor(-cfg.lr * frac, dtype=torch.float64).to(dt).to(
        grads.device)
    norm = torch.sqrt(torch.sum(grads * grads, dim=-1, keepdim=True))
    grads = torch.where(norm < cfg.max_grad_norm, grads,
                        (grads / norm) * cfg.max_grad_norm)
    tr.mu = (1 - b1) * grads + b1 * tr.mu
    tr.nu = (1 - b2) * (grads * grads) + b2 * tr.nu
    upd = step * ((tr.mu / bc1) / (torch.sqrt(tr.nu / bc2) + cfg.adam_eps))
    tr.params = tr.params + upd
    tr.count = c
    return grads


def iteration(cfg: Config, tr: Train, tf32: bool = False,
              fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """One PPO iteration of every member; returns the per-member means over
    its minibatch steps of the loss, (P,).  `fault` plants one of the
    faults the benchmark's check must catch: "half" takes each minibatch's
    gradient over its first half of rows, "reward" adds 1 to every reward
    as it is produced."""
    seed, perms = draw_inputs(cfg, tr.generators)
    with precision(tf32):
        buf = rollout(cfg, tr, seed, fault)
        T, P, B = buf["values"].shape
        adv, ret = gae(buf["rewards"].view(T, P * B),
                       buf["values"].view(T, P * B),
                       buf["dones"].view(T, P * B),
                       buf["last_values"].reshape(P * B),
                       cfg.gamma, cfg.gae_lambda)
        fields = (buf["obs"], buf["actions"][..., None],
                  buf["log_probs"][..., None], buf["values"][..., None],
                  adv.view(T, P, B, 1), ret.view(T, P, B, 1))
        data = torch.cat([f.reshape(T, P, B, -1) for f in fields], -1)
        data = data.transpose(0, 1).reshape(P, T * B, 13)
        n_blocks = T * B // cfg.block
        blocks = data.view(P, n_blocks, cfg.block, 13)
        members = torch.arange(P, device=data.device)[:, None]
        losses = []
        for e in range(cfg.n_epochs):
            mbs = blocks[members, perms[e].to(data.device)].view(
                P, cfg.n_minibatches, cfg.minibatch, 13)
            for j in range(cfg.n_minibatches):
                mb = mbs[:, j]
                if fault == "half":
                    mb = mb[:, :cfg.minibatch // 2]
                loss, grads = loss_and_grads(cfg, tr.params, mb)
                adam(cfg, tr, grads)
                losses.append(loss)
    return {"loss": torch.stack(losses, -1).mean(-1)}
