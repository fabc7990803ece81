"""The port's episode telemetry (`acas2d_tpu_torch/envs/telemetry.py`)
against the JAX package's (`acas2d_tpu/envs/telemetry.py`), float64 on the
CPU, on spawns of the reference's Mersenne stream (seed 13, skip 2):

  * `initial_telemetry` (the t=0 seed records, raw `r_step`);
  * `rollout_telemetry` on fixed random actions over 1000 steps: every
    record within 1e-9 (px, rewards and the rest), as
    tests/test_drivers.py holds the JAX engine to the reference, and
    `done` and `outcome` exactly;
  * `rollout_telemetry_policy` with the flagship params, over 1000 steps,
    likewise.  Both sides run the policy in float64: the two float32 MLPs
    round differently (64% of their actions differ by an ulp), and an ulp
    of action moves the path by ~1e-5 px over an episode
    (tests/test_torch_episode_csv.py measures it);
  * the state `step_with_telemetry` carries equals `core.step`'s bit for
    bit, with the same reward and observation.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.envs import core as jcore
from acas2d_tpu.envs import telemetry as jtelemetry
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic

from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import core, telemetry
from acas2d_tpu_torch.models.actor_critic import ActorCritic, apply_flat
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils.params_io import flat_to_tree, load_flat_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.npz")
B, T = 4, 1000
ATOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawns():
    sp = MersenneSpawner(DEFAULT_PARAMS, seed=13, skip_episodes=2)
    inits = sp.spawn_batch(B)
    return (np.array([i.player_psi for i in inits]),
            np.stack([i.traffic_x for i in inits]),
            np.stack([i.traffic_y for i in inits]),
            np.stack([i.traffic_v for i in inits]),
            np.stack([i.traffic_psi for i in inits]),
            np.array([i.num_traffic for i in inits]))


def _reset():
    spawns = _spawns()
    port = core.reset_from(*spawns, DEFAULT_PARAMS, torch.float64, "cpu")
    jax_ = jax.vmap(lambda *a: jcore.reset_from(*a, JP, jnp.float64))(
        *[jnp.asarray(x) for x in spawns])
    return port, jax_


def _compare(got: telemetry.Telemetry, want, time_axis=True):
    """Port records (T, B, ...) against JAX's vmapped (B, T, ...)."""
    for f in dataclasses.fields(telemetry.Telemetry):
        g = getattr(got, f.name).numpy()
        w = np.asarray(getattr(want, f.name))
        if time_axis:
            w = np.moveaxis(w, 0, 1)
        assert g.shape == w.shape, f.name
        if f.name in ("done", "outcome"):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                       err_msg=f.name)


def test_initial_telemetry_matches_jax():
    (state, _), (jstate, _) = _reset()
    got = telemetry.initial_telemetry(state, DEFAULT_PARAMS)
    want = jax.vmap(lambda s: jtelemetry.initial_telemetry(s, JP))(jstate)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=ATOL,
                                   rtol=0, err_msg=k)


def test_replayed_actions_match_jax():
    (state, _), (jstate, _) = _reset()
    actions = np.random.default_rng(3).uniform(-1, 1, (T, B))
    _, got = telemetry.rollout_telemetry(state, torch.from_numpy(actions),
                                         DEFAULT_PARAMS)
    _, want = jax.jit(jax.vmap(
        lambda s, a: jtelemetry.rollout_telemetry(s, a, JP)))(
        jstate, jnp.asarray(actions.T))
    _compare(got, want)
    assert got.done.any()             # episodes end inside the 1000 steps


def test_greedy_policy_matches_jax():
    (state, obs), (jstate, jobs) = _reset()
    flat, _ = load_flat_params(FLAGSHIP)
    flat = flat.to(torch.float64)
    model = ActorCritic().to(torch.float64)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                           flat_to_tree(flat))
    jmodel = JActorCritic()

    def policy(o):
        return torch.clamp(apply_flat(model, flat, o)[0][:, 0], -1.0, 1.0)

    def jpolicy(o):
        return jnp.clip(jmodel.apply(jparams, o)[0][..., 0], -1.0, 1.0)

    _, got = telemetry.rollout_telemetry_policy(state, obs, T, policy,
                                                DEFAULT_PARAMS)
    _, want = jax.jit(jax.vmap(
        lambda s, o: jtelemetry.rollout_telemetry_policy(s, o, T, jpolicy,
                                                         JP)))(jstate, jobs)
    _compare(got, want)
    assert (got.outcome == 1).any(dim=0).all()    # every episode reaches goal


def test_carried_state_is_core_step_bit_for_bit():
    (state, _), _ = _reset()
    actions = torch.from_numpy(
        np.random.default_rng(4).uniform(-1, 1, (300, B)))
    s_tel, s_core = state, state
    for a in actions:
        s_tel, tel = telemetry.step_with_telemetry(s_tel, a, DEFAULT_PARAMS)
        s_core, out = core.step(s_core, a, DEFAULT_PARAMS)
        for f in dataclasses.fields(EnvState):
            assert torch.equal(getattr(s_tel, f.name),
                               getattr(s_core, f.name)), f.name
        for k in ("obs", "reward", "done", "outcome"):
            assert torch.equal(getattr(tel, k), getattr(out, k)), k


def test_mersenne_reset_is_the_exact_eval_reset():
    """The eval's telemetry and its greedy episodes start from the same
    reset: `learner.mersenne_reset` on the spawner the exact eval uses."""
    (state, obs), _ = _reset()
    sp = MersenneSpawner(DEFAULT_PARAMS, seed=13, skip_episodes=2)
    s2, o2 = learner.mersenne_reset(DEFAULT_PARAMS, sp, B, torch.float64,
                                    "cpu")
    assert torch.equal(obs, o2)
    for f in dataclasses.fields(EnvState):
        assert torch.equal(getattr(state, f.name), getattr(s2, f.name))
