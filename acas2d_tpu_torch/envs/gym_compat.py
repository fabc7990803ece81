"""Single-env Gym(nasium) adapters over the batch-native core (torch).

Counterpart of `acas2d_tpu/envs/gym_compat.py`: the reference's L3 layer
(environment.py:10-54 and the 'ACAS2D-v0' registration,
gym_ACAS2D/__init__.py:3-6) as a Python-stateful env for users of the gym
API, backed by the port's `core.reset_from` / `core.reset` / `core.step`
on a batch of one env.

Two flavours:
  * ACAS2DEnv — gymnasium.Env (5-tuple step).  Timeout maps to `truncated`,
    collision/goal to `terminated`; `info['outcome']` carries the reference
    outcome code.  Registered as 'ACAS2D-v0' on import when gymnasium is
    installed (`register_gymnasium`).
  * LegacyACAS2DEnv — the reference's old-gym 4-tuple surface
    (obs, reward, done, info with info == {}; environment.py:29-42).

Both take `device` (default CUDA; `device="cpu"` for the plain CPU path,
never chosen on their own) and `dtype` (default float32, as a JAX process
without x64; float64 on request).  Spawning replays the host Mersenne
stream by default (`exact_spawn=True`), so a process that seeds once and
resets repeatedly sees the reference's episode sequence; with
`exact_spawn=False` episodes spawn from a `torch.Generator` on the device.

A step on the card is the core's few dozen small launches and one
device-to-host copy: the observation, reward, done flag and outcome come
back together in one float64 tensor, where the JAX adapter reads each
back on its own.  gymnasium (and old gym) are optional: without gymnasium
the spaces are `_PlainBox`es and ACAS2DEnv is not defined.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams
from acas2d_tpu_torch.envs import core
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.types import EnvState

try:
    import gymnasium
    from gymnasium import spaces
    _HAS_GYMNASIUM = True
except ImportError:
    gymnasium = None
    _HAS_GYMNASIUM = False

ENV_ID = "ACAS2D-v0"


class _EnvBackend:
    """The core on one env, shared by both API flavours."""

    def __init__(self, params: EnvParams, exact_spawn: bool = True,
                 seed: Optional[int] = None, dtype=torch.float32,
                 device=None):
        self.p = params
        self.dtype = dtype
        self.device = resolve_device(device)
        self.exact_spawn = exact_spawn
        self.seed(params.seed if seed is None else seed)
        self.state: Optional[EnvState] = None

    def seed(self, seed: int):
        self._spawner = MersenneSpawner(self.p, seed=seed)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def reset(self) -> np.ndarray:
        if self.exact_spawn:
            i = self._spawner.spawn()
            self.state, obs = core.reset_from(
                [i.player_psi], i.traffic_x[None], i.traffic_y[None],
                i.traffic_v[None], i.traffic_psi[None], [i.num_traffic],
                self.p, self.dtype, self.device)
        else:
            self.state, obs = core.reset(1, self.p, self._generator,
                                         self.dtype, self.device)
        return obs[0].to(torch.float64).cpu().numpy()

    def step(self, action):
        """(obs float64, reward, done, outcome) of one step, read back in
        one copy."""
        a = float(np.asarray(action).reshape(-1)[0])
        self.state, out = core.step(
            self.state, torch.tensor([a], dtype=self.dtype,
                                     device=self.device), self.p)
        f64 = torch.float64
        host = torch.cat([out.obs[0].to(f64), out.reward.to(f64),
                          out.done.to(f64), out.outcome.to(f64)]).cpu().numpy()
        o = self.p.obs_dim
        return host[:o], float(host[o]), bool(host[o + 1]), int(host[o + 2])

    # -- introspection used by renderers / drivers
    @property
    def game_state(self) -> EnvState:
        """The env's state on the host: numpy scalars, and (max_traffic,)
        arrays for the traffic fields."""
        return EnvState(**{k: v[0].cpu().numpy()
                           for k, v in vars(self.state).items()})


class _PlainBox:
    """Minimal Box stand-in when gymnasium is absent: exposes the same
    low/high/shape/dtype surface plus contains(), so the reference's
    check_env contract (utils/env_check.py) stays verifiable."""

    def __init__(self, low, high, shape=None, dtype=np.float64):
        low = np.broadcast_to(np.asarray(low, dtype), shape) if shape else \
            np.asarray(low, dtype)
        high = np.broadcast_to(np.asarray(high, dtype), shape) if shape else \
            np.asarray(high, dtype)
        self.low, self.high = low, high
        self.shape = low.shape
        self.dtype = np.dtype(dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and np.all(x >= self.low)
                and np.all(x <= self.high))

    def __repr__(self):
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"


def _box_spaces(params: EnvParams):
    """Observation/action boxes exactly as environment.py:15-27.

    Uses gymnasium.spaces.Box when available, else the plain stand-in — the
    LegacyACAS2DEnv contract surface must not silently shrink without
    gymnasium installed."""
    box = spaces.Box if _HAS_GYMNASIUM else _PlainBox
    lo = np.array([0, 0, -1, 0, 0] + [0, -1, -1] * params.max_traffic,
                  dtype=np.float64)
    hi = np.ones(params.obs_dim, dtype=np.float64)
    obs_space = box(low=lo, high=hi, dtype=np.float64)
    act_space = box(low=-1.0, high=1.0, shape=(1,), dtype=np.float64)
    return obs_space, act_space


if _HAS_GYMNASIUM:

    class ACAS2DEnv(gymnasium.Env):
        metadata = {"render_modes": ["rgb_array"], "render_fps": 100}

        def __init__(self, params: EnvParams = DEFAULT_PARAMS,
                     exact_spawn: bool = True,
                     render_mode: Optional[str] = None,
                     device=None, dtype=torch.float32):
            self.p = params
            self._backend = _EnvBackend(params, exact_spawn, dtype=dtype,
                                        device=device)
            self.observation_space, self.action_space = _box_spaces(params)
            self.render_mode = render_mode
            self._trail = []

        def reset(self, *, seed: Optional[int] = None, options=None):
            super().reset(seed=seed)
            if seed is not None:
                self._backend.seed(seed)
            obs = self._backend.reset()
            self._trail = []
            return obs, {}

        def step(self, action):
            obs, reward, done, outcome = self._backend.step(action)
            terminated = done and outcome in (1, 2)
            truncated = done and outcome == 3
            if self.render_mode is not None:
                s = self._backend.game_state
                self._trail.append((float(s.px), float(s.py)))
            return obs, reward, terminated, truncated, {"outcome": outcome}

        def render(self):
            if self.render_mode != "rgb_array":
                return None
            from acas2d_tpu_torch.render import render_frame
            s = self._backend.game_state
            return render_frame(
                float(s.px), float(s.py), float(s.ppsi),
                np.asarray(s.tx), np.asarray(s.ty),
                int(s.num_traffic), self.p, trail=self._trail)


def register_gymnasium() -> bool:
    """Register 'ACAS2D-v0' with this module's ACAS2DEnv as its entry
    point, as the JAX package registers its own (gymnasium's registry is
    one per process, so the later registration wins; tests that register
    here put the earlier entry back).  Returns whether gymnasium is
    installed."""
    if _HAS_GYMNASIUM:
        gymnasium.register(id=ENV_ID,
                           entry_point=f"{__name__}:ACAS2DEnv")
    return _HAS_GYMNASIUM


register_gymnasium()


class LegacyACAS2DEnv:
    """The reference's exact old-gym surface (environment.py:29-54):
    step -> (obs, reward, done, {}), reset -> obs, no-op close."""

    def __init__(self, params: EnvParams = DEFAULT_PARAMS,
                 exact_spawn: bool = True, device=None,
                 dtype=torch.float32):
        self.p = params
        self._backend = _EnvBackend(params, exact_spawn, dtype=dtype,
                                    device=device)
        self.observation_space, self.action_space = _box_spaces(params)
        self.outcome = None

    def reset(self):
        self.outcome = None
        return self._backend.reset()

    def step(self, action):
        obs, reward, done, outcome = self._backend.step(action)
        if done:
            self.outcome = outcome
        return obs, reward, done, {}

    def seed(self, seed: int):
        """Old-gym seeding surface; the reference seeds the global
        `random` module once per process instead (training_main.py:14)."""
        self._backend.seed(seed)
        return [seed]

    def render(self, mode="human"):
        pass

    def close(self):
        pass


# Best-effort legacy-gym registration (the reference registers 'ACAS2D-v0'
# under old `gym`, gym_ACAS2D/__init__.py:3-6).  Old gym is not a
# dependency of this package; when a user's environment has a 4-tuple-era
# release (< 0.26, the API the reference targets) installed,
# `gym.make("ACAS2D-v0")` resolves to the 4-tuple legacy env below.
# gym >= 0.26 switched to the gymnasium-style 5-tuple API (and wraps
# every made env in checkers that enforce it), so there the registration
# is skipped — those users get the gymnasium 'ACAS2D-v0' above.
def _old_gym_api(mod) -> bool:
    try:
        major, minor = str(getattr(mod, "__version__", "999")).split(".")[:2]
        return (int(major), int(minor)) < (0, 26)
    except (ValueError, TypeError):
        return False


try:
    import gym as _legacy_gym
    _HAS_LEGACY_GYM = _old_gym_api(_legacy_gym)
except ImportError:
    _legacy_gym = None
    _HAS_LEGACY_GYM = False

if _HAS_LEGACY_GYM:                                      # pragma: no cover

    class LegacyGymACAS2DEnv(LegacyACAS2DEnv, _legacy_gym.Env):
        """LegacyACAS2DEnv as a registered old-gym (< 0.26) Env."""
        metadata = {"render.modes": []}

        def reset(self, seed=None, options=None, **kwargs):
            if seed is not None:
                self.seed(seed)
            return super().reset()

    # old-gym registries keep specs in `env_specs`; only a re-register is
    # expected and tolerable here, so check membership explicitly and let
    # real failures (entry-point typos, gym internals drift) surface at
    # import time instead of being swallowed.
    _specs = getattr(_legacy_gym.envs.registry, "env_specs", {})
    if ENV_ID not in _specs:
        _legacy_gym.register(
            id=ENV_ID, entry_point=f"{__name__}:LegacyGymACAS2DEnv")
