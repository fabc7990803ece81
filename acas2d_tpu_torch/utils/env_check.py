"""Environment contract checker — the SB3 `check_env` stand-in.

Counterpart of `acas2d_tpu/utils/env_check.py`.  Every reference driver
validates its env before use (`check_env(environment, warn=True,
skip_render_check=True)`, training_main.py:23 etc.).  This applies the
same contract checks to both the port's batch-native core and its gym
adapters: observation bounds/dtype/shape, action handling, reset/step
signatures, determinism of reset under a fixed seed, and reward
finiteness.  Where JAX splits PRNG keys, the core's checks draw from
`torch.Generator`s on the env's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import EnvParams, DEFAULT_PARAMS
from acas2d_tpu_torch.envs import core


class EnvCheckError(AssertionError):
    pass


def _check(cond, msg):
    if not cond:
        raise EnvCheckError(msg)


def check_functional_env(params: EnvParams = DEFAULT_PARAMS,
                         n_random_steps: int = 200,
                         seed: int = 0, device=None) -> None:
    """Validate the core's contract on one env (float32, as JAX's check)
    on `device` (default CUDA)."""
    dev = resolve_device(device)

    def generator():
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    state, obs = core.reset(1, params, generator(), torch.float32, dev)
    _check(tuple(obs.shape) == (1, params.obs_dim),
           f"obs shape {tuple(obs.shape)} != (1, {params.obs_dim})")
    _check(int(state.steps[0]) == 1, "reset must leave steps == 1 "
           "(observe-increments semantics, game.py:197)")
    # Determinism: same seed -> same state.
    _, obs2 = core.reset(1, params, generator(), torch.float32, dev)
    np.testing.assert_array_equal(obs.cpu().numpy(), obs2.cpu().numpy())

    lo = np.array([0, 0, -1, 0, 0] + [0, -1, -1] * params.max_traffic)
    hi = np.ones(params.obs_dim)
    g = generator()
    o_dim = params.obs_dim
    for i in range(n_random_steps):
        a = torch.rand(1, generator=g, device=dev) * 2 - 1
        state, out = core.step_autoreset(state, a, params, generator=g)
        host = torch.cat([out.obs[0].double(), out.reward.double(),
                          out.outcome.double()]).cpu().numpy()
        o = host[:o_dim]
        _check(np.all(np.isfinite(o)), f"non-finite obs at step {i}")
        _check(np.all(o >= lo - 1e-6) and np.all(o <= hi + 1e-6),
               f"obs outside declared Box at step {i}: {o}")
        _check(np.isfinite(host[o_dim]), f"non-finite reward at {i}")
        _check(int(host[o_dim + 1]) in (0, 1, 2, 3), "bad outcome code")


def check_gym_env(env, n_random_steps: int = 100,
                  seed: Optional[int] = 0) -> None:
    """Validate a gym/gymnasium-style adapter (5-tuple or legacy 4-tuple)."""
    rng = np.random.default_rng(seed)
    out = env.reset(seed=seed) if _is_gymnasium(env) else env.reset()
    obs = out[0] if isinstance(out, tuple) else out
    _check(isinstance(obs, np.ndarray), "reset must return ndarray obs")
    if hasattr(env, "observation_space"):
        _check(env.observation_space.contains(obs),
               f"reset obs outside observation_space: {obs}")
    for i in range(n_random_steps):
        a = rng.uniform(-1, 1, size=(1,))
        res = env.step(a)
        _check(len(res) in (4, 5), "step must return a 4- or 5-tuple")
        obs, reward = res[0], res[1]
        _check(isinstance(obs, np.ndarray) and np.all(np.isfinite(obs)),
               f"bad obs at step {i}")
        _check(np.isfinite(reward), f"non-finite reward at step {i}")
        done = res[2] if len(res) == 4 else (res[2] or res[3])
        if done:
            out = env.reset(seed=None) if _is_gymnasium(env) else env.reset()
            obs = out[0] if isinstance(out, tuple) else out


def _is_gymnasium(env) -> bool:
    try:
        import gymnasium
        return isinstance(env, gymnasium.Env) or isinstance(
            getattr(env, "unwrapped", None), gymnasium.Env)
    except ImportError:
        return False
