"""Actor-critic policy network matching SB3's default MlpPolicy.

Counterpart of `acas2d_tpu/models/actor_critic.py:47-98`:

  * separate pi and vf towers, each Linear(64) -> tanh -> Linear(64) -> tanh
  * action head Linear(1), value head Linear(1)
  * orthogonal init: tower gains sqrt(2), action head 0.01, value head 1.0;
    zero biases
  * a state-independent log-std parameter, initialized to 0, clamped to
    [-4, 2] in the forward pass with a straight-through gradient

`flatten(model)` lists the parameters in the order the kernels read them
(`param_names`): per tower W1 (64, 8), b1, W2 (64, 64), b2, head weight
(1, 64), head bias — the pi tower with the action head, then the vf tower
with the value head — and log_std last: 9,603 floats (`N_PARAMS`).
`nn.Linear.weight` is (out, in), the transpose of a flax kernel
(`utils.params_io.from_jax_params` converts).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

OBS_DIM = 8
HIDDEN = 64
# per tower: W1 + b1 + W2 + b2 + head weight + head bias
TOWER_PARAMS = HIDDEN * OBS_DIM + HIDDEN + HIDDEN * HIDDEN + HIDDEN + HIDDEN + 1
N_PARAMS = 2 * TOWER_PARAMS + 1          # + log_std
LOG_2PI = math.log(2.0 * math.pi)


class MlpTower(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int] = (HIDDEN, HIDDEN)):
        super().__init__()
        dims = [in_dim, *hidden]
        for i in range(len(hidden)):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n_layers = len(hidden)

    def forward(self, x):
        for i in range(self.n_layers):
            x = torch.tanh(getattr(self, f"dense_{i}")(x))
        return x


class ActorCritic(nn.Module):
    """forward(obs) -> (action_mean (..., act_dim), log_std (act_dim,),
    value (...,))."""

    def __init__(self, obs_dim: int = OBS_DIM, act_dim: int = 1,
                 hidden: Sequence[int] = (HIDDEN, HIDDEN),
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.pi_tower = MlpTower(obs_dim, hidden)
        self.action_head = nn.Linear(hidden[-1], act_dim)
        self.vf_tower = MlpTower(obs_dim, hidden)
        self.value_head = nn.Linear(hidden[-1], 1)
        self.log_std = nn.Parameter(torch.zeros(act_dim))
        self.reset_parameters(generator)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """SB3 init: orthogonal weights (gains sqrt(2) / 0.01 / 1), zero
        biases, log_std 0.  The orthogonal factor's QR runs on one thread:
        its rounding depends on the intra-op thread count, and a process of
        a launch (OMP_NUM_THREADS=1) must start from the same policy as one
        that trains alone."""
        def init(layer: nn.Linear, gain: float):
            nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
            nn.init.zeros_(layer.bias)

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for tower in (self.pi_tower, self.vf_tower):
                for i in range(tower.n_layers):
                    init(getattr(tower, f"dense_{i}"), math.sqrt(2.0))
            init(self.action_head, 0.01)
            init(self.value_head, 1.0)
        finally:
            torch.set_num_threads(threads)
        self.log_std.zero_()

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean = self.action_head(self.pi_tower(obs))
        value = self.value_head(self.vf_tower(obs))
        # Straight-through clamp: the forward value is clipped to [-4, 2],
        # the gradient is the identity, so the optimizer can always pull
        # the parameter back inside.
        log_std = self.log_std
        log_std = log_std + (torch.clamp(log_std, -4.0, 2.0) - log_std).detach()
        return mean, log_std, value.squeeze(-1)


# ------------------------------------------------- flat parameter vector

def param_names(model: nn.Module):
    """Parameter names in kernel order: tower by tower (layers, then the
    head), log_std last.  (`model.parameters()` lists log_std first: a
    module's own parameters precede its submodules'.)"""
    names = [n for n, _ in model.named_parameters() if n != "log_std"]
    pi = [n for n in names if n.startswith(("pi_tower.", "action_head."))]
    vf = [n for n in names if n.startswith(("vf_tower.", "value_head."))]
    return pi + vf + ["log_std"]


def flatten(model: nn.Module) -> torch.Tensor:
    """The model's parameters as one (N_PARAMS,) vector in kernel order."""
    params = dict(model.named_parameters())
    return torch.cat([params[n].detach().reshape(-1)
                      for n in param_names(model)])


def unflatten(model: nn.Module, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Views of `flat` shaped and named like `model.named_parameters()`."""
    params = dict(model.named_parameters())
    out, i = {}, 0
    for name in param_names(model):
        p = params[name]
        out[name] = flat[i:i + p.numel()].view_as(p)
        i += p.numel()
    if i != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values for a model "
                         f"of {i} parameters")
    return out


def apply_flat(model: nn.Module, flat: torch.Tensor, obs: torch.Tensor):
    """`model(obs)` with its parameters taken from `flat`."""
    return torch.func.functional_call(model, unflatten(model, flat), (obs,))


# ------------------------------------------------- gaussian policy helpers

def gaussian_log_prob(x, mean, log_std):
    """Sum over the action axis of the diagonal-gaussian log density
    (SB3 DiagGaussianDistribution.log_prob)."""
    var = torch.exp(2 * log_std)
    lp = -0.5 * ((x - mean) ** 2 / var + 2 * log_std + LOG_2PI)
    return lp.sum(-1)


def gaussian_entropy(log_std):
    """Summed diagonal-gaussian entropy: 0.5*(1+log(2pi)) + log_std per dim."""
    return (0.5 * (1.0 + LOG_2PI) + log_std).sum(-1)


def sample_action(mean, log_std, noise):
    """Reparameterised sample mean + exp(log_std) * noise, with the standard
    normal `noise` an input (JAX draws it inside from a key).  NOT clipped:
    log-probs are taken of the raw sample, and the env receives a clipped
    copy (SB3 collect_rollouts)."""
    return mean + torch.exp(log_std) * noise


def split_flat(flat: torch.Tensor):
    """Views of a flat (N_PARAMS,) vector of the default architecture:
    ((W1, b1, W2, b2, w_head, b_head) of the pi tower, the same of the vf
    tower, log_std (1,)), with W1 (64, 8), W2 (64, 64), w_head (64,)."""
    if flat.shape != (N_PARAMS,):
        raise ValueError(f"expected a ({N_PARAMS},) parameter vector, got "
                         f"{tuple(flat.shape)}")
    shapes = [(HIDDEN, OBS_DIM), (HIDDEN,), (HIDDEN, HIDDEN), (HIDDEN,),
              (HIDDEN,), (1,)]
    towers, i = [], 0
    for _ in range(2):
        views = []
        for s in shapes:
            n = math.prod(s)
            views.append(flat[i:i + n].view(s))
            i += n
        towers.append(tuple(views))
    return towers[0], towers[1], flat[i:i + 1]


def tower_forward(x, tower):
    """One tower and its head on x (N, 8): (h1, h2, out (N,))."""
    w1, b1, w2, b2, wh, bh = tower
    h1 = torch.tanh(F.linear(x, w1, b1))
    h2 = torch.tanh(F.linear(h1, w2, b2))
    return h1, h2, h2 @ wh + bh


def members_forward(params: torch.Tensor, obs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P member policies, each on its own observations, as batched matrix
    products: params (P, N_PARAMS), obs (P, N, 8) -> (action mean (P, N),
    value (P, N)).  (The JAX population vmaps `model.apply` over members.)"""
    P = params.shape[0]
    outs, i = [], 0
    for _ in range(2):
        w1 = params[:, i:i + HIDDEN * OBS_DIM].unflatten(-1, (HIDDEN, OBS_DIM))
        i += HIDDEN * OBS_DIM
        b1 = params[:, i:i + HIDDEN]
        i += HIDDEN
        w2 = params[:, i:i + HIDDEN * HIDDEN].unflatten(-1, (HIDDEN, HIDDEN))
        i += HIDDEN * HIDDEN
        b2 = params[:, i:i + HIDDEN]
        i += HIDDEN
        wh = params[:, i:i + HIDDEN]
        bh = params[:, i + HIDDEN:i + HIDDEN + 1]
        i += HIDDEN + 1
        h1 = torch.tanh(torch.baddbmm(b1[:, None], obs, w1.transpose(1, 2)))
        h2 = torch.tanh(torch.baddbmm(b2[:, None], h1, w2.transpose(1, 2)))
        outs.append(torch.bmm(h2, wh.reshape(P, HIDDEN, 1))[..., 0] + bh)
    return outs[0], outs[1]


def members_log_std(params: torch.Tensor) -> torch.Tensor:
    """Each member's log_std (P,) of params (P, N_PARAMS), clamped to
    [-4, 2] with the straight-through gradient of `ActorCritic.forward`."""
    log_std = params[:, -1]
    return log_std + (torch.clamp(log_std, -4.0, 2.0) - log_std).detach()
