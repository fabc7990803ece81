"""The port's batch-native env core vs the scalar oracle and the JAX engine,
float64 on the CPU.

Tolerances (as tests/test_jax_parity.py, and for the same reason): libm
and torch transcendentals may differ in the last ulp, so positions are held
to 1e-9 px over whole episodes, observations and rewards to 1e-9 and
episode returns to 1e-8; outcomes, termination steps and step counts must
match exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu import config as jcfg
from acas2d_tpu.envs import core as jcore
from acas2d_tpu.envs import vector as jvector
from acas2d_tpu.oracle import MersenneSpawner as JSpawner, OracleEnv
from acas2d_tpu_torch import config as tcfg
from acas2d_tpu_torch.envs import core, vector
from acas2d_tpu_torch.ops import kinematics as K
from acas2d_tpu_torch.oracle import MersenneSpawner

F64 = torch.float64


def _reset_from(inits, params, device="cpu"):
    return core.reset_from(
        np.array([i.player_psi for i in inits]),
        np.stack([i.traffic_x for i in inits]),
        np.stack([i.traffic_y for i in inits]),
        np.stack([i.traffic_v for i in inits]),
        np.stack([i.traffic_psi for i in inits]),
        np.array([i.num_traffic for i in inits]), params, F64, device)


def _run_pair(action, n_episodes, bug_compat):
    """The port steps all episodes as one batch; the oracle steps them one
    by one from the same Mersenne stream."""
    jp = jcfg.EnvParams(bug_compat=bug_compat)
    tp = tcfg.EnvParams(bug_compat=bug_compat)
    inits = MersenneSpawner(tp, skip_episodes=2).spawn_batch(n_episodes)
    sp_o = JSpawner(jp, skip_episodes=2)
    oracles = [OracleEnv(jp, spawner=sp_o) for _ in range(n_episodes)]
    obs_o = [o.reset() for o in oracles]
    state, obs = _reset_from(inits, tp)
    np.testing.assert_allclose(obs.numpy(), np.stack(obs_o), atol=1e-12, rtol=0)
    live = list(range(n_episodes))
    for t in range(tp.max_steps):
        acts = torch.tensor([action(ep, t) for ep in range(n_episodes)], dtype=F64)
        state, out = core.step(state, acts, tp)
        for ep in list(live):
            ob, r, done, _ = oracles[ep].step(np.array([float(acts[ep])]))
            s = oracles[ep].state
            assert bool(out.done[ep]) == done, (ep, t)
            np.testing.assert_allclose(out.obs[ep].numpy(), ob, atol=1e-9, rtol=0)
            np.testing.assert_allclose(float(out.reward[ep]), r, atol=1e-9, rtol=0)
            np.testing.assert_allclose(
                [float(state.px[ep]), float(state.py[ep]), float(state.ppsi[ep])],
                [s.px, s.py, s.ppsi], atol=1e-9, rtol=0)
            np.testing.assert_allclose(state.tx[ep].numpy(), s.tx, atol=1e-9, rtol=0)
            if done:
                assert int(out.outcome[ep]) == s.outcome, (ep, t)
                assert int(state.steps[ep]) == s.steps, (ep, t)
                assert int(out.episode_steps[ep]) == s.steps
                np.testing.assert_allclose(float(out.episode_return[ep]),
                                           s.total_reward, atol=1e-8, rtol=0)
                live.remove(ep)
        if not live:
            return
    raise AssertionError("an episode did not end within max_steps")


_RNG_ACTS = np.random.default_rng(42).uniform(-1, 1, size=(4, 1000))
REPLAYS = {
    "zero": (lambda ep, t: 0.0, 4),
    "random": (lambda ep, t: float(_RNG_ACTS[ep, t]), 4),
    # gym_main.py:36 scripted policy: action = (episode % 3) - 1
    "constant_turn": (lambda ep, t: float((ep + 1) % 3 - 1), 3),
}


@pytest.mark.parametrize("bug_compat", [True, False])
@pytest.mark.parametrize("replay", sorted(REPLAYS))
def test_replays_match_oracle(replay, bug_compat):
    action, n = REPLAYS[replay]
    _run_pair(action, n, bug_compat)


@pytest.mark.parametrize("bug_compat", [True, False])
def test_batch_matches_jax_engine(bug_compat):
    """One batch of 16 envs, 200 random-action steps without respawn, against
    the JAX engine's vmapped step in x64."""
    jp = jcfg.EnvParams(bug_compat=bug_compat)
    tp = tcfg.EnvParams(bug_compat=bug_compat)
    inits = MersenneSpawner(tp, seed=5).spawn_batch(16)
    acts = np.random.default_rng(0).uniform(-1, 1, size=(200, 16))
    state, obs = _reset_from(inits, tp)
    js, jobs = jax.vmap(lambda *a: jcore.reset_from(*a, jp, jnp.float64))(
        *(jnp.asarray(x) for x in (
            np.array([i.player_psi for i in inits]),
            np.stack([i.traffic_x for i in inits]),
            np.stack([i.traffic_y for i in inits]),
            np.stack([i.traffic_v for i in inits]),
            np.stack([i.traffic_psi for i in inits]),
            np.array([i.num_traffic for i in inits]))))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-12, rtol=0)
    _, jout = jax.jit(lambda s, a: jvector.rollout_actions(s, a, jp))(
        js, jnp.asarray(acts))
    for t in range(200):
        state, out = vector.step_batch(state, torch.as_tensor(acts[t]), tp)
        np.testing.assert_allclose(out.obs.numpy(), np.asarray(jout.obs[t]),
                                   atol=1e-9, rtol=0)
        np.testing.assert_allclose(out.reward.numpy(),
                                   np.asarray(jout.reward[t]), atol=1e-9, rtol=0)
        np.testing.assert_array_equal(out.outcome.numpy(),
                                      np.asarray(jout.outcome[t]))


def test_autoreset_respawns_and_keeps_terminal_info():
    """A terminated env reports its episode and returns the reset obs
    (SB3 DummyVecEnv semantics); respawns follow the spawn distributions."""
    p = tcfg.DEFAULT_PARAMS
    gen = torch.Generator().manual_seed(3)
    state, obs = vector.reset_batch(16, p, gen, F64, "cpu")
    ended = torch.zeros(16, dtype=torch.bool)
    for _ in range(800):                      # zero action ends every episode
        state, out = core.step_autoreset(state, torch.zeros(16), p, gen)
        if out.done.any():
            d = out.done
            assert (out.episode_steps[d] > 0).all()
            assert (out.episode_return[d] != 0).all()
            np.testing.assert_allclose(out.obs[d, 0].numpy(), 1.0 / p.max_steps)
            assert (state.steps[d] == 1).all() and (state.px[d] == p.player_x0).all()
            ended |= d
    assert ended.all()


def test_spawn_distribution():
    p = tcfg.DEFAULT_PARAMS
    s = core.spawn(4096, p, torch.Generator().manual_seed(0), F64, "cpu")
    bearing = 0.0     # the goal is level with the player spawn
    dpsi = (s.ppsi - bearing + 180) % 360 - 180
    assert dpsi.abs().max() <= p.player_initial_heading_lim
    assert dpsi.std() > 1.0
    top = s.ty[:, 0] == p.collision_radius
    bottom = s.ty[:, 0] == p.height - p.collision_radius
    assert (top | bottom).all() and 0.4 < top.double().mean() < 0.6
    assert (s.tx[:, 0] == p.width - p.collision_radius).all()
    assert (s.tv == p.airspeed).all()
    head = torch.where(top, s.tpsi[:, 0] - 145, s.tpsi[:, 0] - 215)
    assert head.abs().max() <= p.traffic_initial_heading_lim
    assert (s.num_traffic == 1).all() and (s.steps == 0).all()


_INIT = MersenneSpawner(tcfg.DEFAULT_PARAMS, seed=0).spawn_batch(2)
_DEFAULT_DEVICE_CALLS = {
    "spawn": lambda: core.spawn(4),
    "reset": lambda: core.reset(4)[0],
    "reset_batch": lambda: vector.reset_batch(4)[0],
    "reset_from": lambda: _reset_from(_INIT, tcfg.DEFAULT_PARAMS, None)[0],
}


@pytest.mark.parametrize("entry", sorted(_DEFAULT_DEVICE_CALLS))
def test_env_entry_points_default_to_cuda(entry):
    """Without a device argument the env's entry points run on CUDA, and
    raise where there is none: they never drop to the CPU on their own."""
    call = _DEFAULT_DEVICE_CALLS[entry]
    if torch.cuda.is_available():
        assert call().px.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_singular_kinematics_corners_are_finite():
    """The 0/0 corners where the reference raises yield finite values
    (tests/test_jax_parity.py:146)."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731
    dca = K.distance_closest_approach(f(100.0), f(200.0), f(200.0), f(37.25),
                                      f(900.0), f(800.0), f(200.0), f(37.25),
                                      bug_compat=True)
    assert torch.isfinite(dca)
    dca2 = K.distance_closest_approach(f(0.0), f(0.0), f(200.0), f(90.0),
                                       f(500.0), f(500.0), f(200.0), f(270.0),
                                       bug_compat=True)
    assert torch.isfinite(dca2)
    c = K.closing_speed(f(100.0), f(100.0), f(200.0), f(0.0), f(0.0),
                        f(100.0), f(100.0), f(200.0), f(0.0), f(0.0), 0.01,
                        bug_compat=True)
    assert float(c) == 0.0
