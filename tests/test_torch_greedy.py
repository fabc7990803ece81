"""The greedy eval's chunked loop (`learner.greedy_rollout` and
`learner.GreedyEval`, which on a CUDA device replays each 64-step chunk as
a CUDA graph) equals the one-step loop it replaced, bit for bit, on the
CPU: a solo float32 policy on sampled spawns, the float64 exact protocol
on Mersenne spawns, and two members side by side.  The trained flagship
policy ends its episodes early, so the host's early exit after a chunk is
exercised; a random policy that always turns flies in circles until it
times out, so the 40 steps after the last full chunk (max_steps 1000) are
too.

The one-step loop is the port's greedy loop as it was before the chunks,
kept here as the reference.

The same loop is held against the JAX package's greedy eval
(`learner._greedy_eval_metrics`, one `lax.scan` of max_steps) on the same
params and start states: a float32 batch of the port's spawns, the float64
exact eval (`make_exact_eval_fn`) on the JAX package's own Mersenne
stream, and the population eval member by member.  Lengths, goal and
collision rates agree exactly; the return mean and std to rtol 1e-5 in
float32 (the two MLPs round differently, test_torch_policy_rollout.py) and
1e-7 in float64 (JAX promotes the policy to float64 there, the port runs it
in float32), where a wrong reward or a step too many is off by 1e-3 or
more."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acas2d_tpu import types as jtypes
from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ppo import learner as jlearner
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig

from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import core, vector
from acas2d_tpu_torch.models.actor_critic import (ActorCritic, apply_flat,
                                                  flatten, members_forward)
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils.params_io import flat_to_tree, load_flat_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.npz")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@torch.no_grad()
def one_step_loop(policy_mean, env_state, obs, env_params):
    n = obs.shape[0]
    dtype = env_state.px.dtype
    ret = torch.zeros(n, dtype=dtype)
    length = torch.zeros(n, dtype=torch.int32)
    outcome = torch.zeros(n, dtype=torch.int32)
    done_seen = torch.zeros(n, dtype=torch.bool)
    for t in range(env_params.max_steps):
        a = torch.clamp(policy_mean(obs), -1.0, 1.0).to(dtype)
        env_state, out = vector.step_batch(env_state, a, env_params)
        active = ~done_seen
        ret = ret + torch.where(active, out.reward, 0.0)
        length = length + active.to(torch.int32)
        outcome = torch.where(active & out.done, out.outcome, outcome)
        done_seen = done_seen | out.done
        obs = out.obs
        if t % 64 == 63 and bool(done_seen.all()):
            break
    return {"return": ret, "length": length, "outcome": outcome,
            "done": done_seen}


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _flagship():
    return load_flat_params(FLAGSHIP)[0]


def _random_policy(seed):
    return flatten(ActorCritic(generator=torch.Generator().manual_seed(seed)))


def _circling_policy(seed):
    model = ActorCritic(generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.action_head.bias.fill_(1.0)          # a full turn, always
    return flatten(model)


@pytest.mark.parametrize("policy", ["flagship", "circling"])
def test_solo_float32_equals_the_one_step_loop(policy):
    params = _flagship() if policy == "flagship" else _circling_policy(3)
    gen = torch.Generator().manual_seed(11)
    es, obs = vector.reset_batch(6, DEFAULT_PARAMS, gen, torch.float32, "cpu")
    model = ActorCritic()
    want = one_step_loop(lambda o: apply_flat(model, params, o)[0][:, 0],
                         es, obs, DEFAULT_PARAMS)
    got = learner.GreedyEval(device="cpu")(params, es, obs, DEFAULT_PARAMS)
    _same(got, want)
    if policy == "flagship":                    # ended before the last chunk
        assert int(want["length"].max()) < 960
        assert bool(want["done"].all())
    else:                                       # ran into the tail
        assert want["length"].tolist() == [1000] * 6


def test_exact_float64_mersenne_equals_the_one_step_loop():
    params = _flagship()
    got = learner.exact_episodes(
        params, DEFAULT_PARAMS, MersenneSpawner(DEFAULT_PARAMS,
                                                skip_episodes=2),
        8, torch.float64, "cpu")
    inits = MersenneSpawner(DEFAULT_PARAMS, skip_episodes=2).spawn_batch(8)
    es, obs = core.reset_from(
        np.array([i.player_psi for i in inits]),
        np.stack([i.traffic_x for i in inits]),
        np.stack([i.traffic_y for i in inits]),
        np.stack([i.traffic_v for i in inits]),
        np.stack([i.traffic_psi for i in inits]),
        np.array([i.num_traffic for i in inits]),
        DEFAULT_PARAMS, torch.float64, "cpu")
    model = ActorCritic()
    want = one_step_loop(
        lambda o: apply_flat(model, params, o.to(torch.float32))[0][:, 0],
        es, obs, DEFAULT_PARAMS)
    _same(got, want)
    assert got["return"].dtype == torch.float64
    assert int(want["outcome"].eq(1).sum()) == 8       # the flagship's goals


def test_two_members_equal_the_one_step_loop():
    flag = _flagship()
    params = torch.stack([flag, flag + 1e-3 * _random_policy(5)])
    n = 4
    gen = torch.Generator().manual_seed(2)
    es, obs = vector.reset_batch(2 * n, DEFAULT_PARAMS, gen, torch.float32,
                                 "cpu")
    want = one_step_loop(
        lambda o: members_forward(params, o.view(2, n, -1))[0].reshape(-1),
        es, obs, DEFAULT_PARAMS)
    got = learner.GreedyEval(members=True, device="cpu")(
        params, es, obs, DEFAULT_PARAMS)
    _same(got, want)
    # the population eval is the same loop on the generator's spawns
    cfg = PPOConfig(eval_episodes=n)
    em = population.make_population_eval(cfg, DEFAULT_PARAMS, device="cpu")(
        params, torch.Generator().manual_seed(2))
    ep = {k: v.view(2, n) for k, v in want.items()}
    for k, v in learner.eval_metrics(ep).items():
        assert torch.equal(em[k], v), k


# ------------------------------------------------ against the JAX package

def _jax_greedy(n):
    """JAX's greedy eval of n float32 envs from a given start state."""
    return jax.jit(lambda params, es, obs: jlearner._greedy_eval_metrics(
        JActorCritic(), params, es, obs, n, JP, jnp.float32))


def _jax_state(es):
    n = es.px.shape[0]
    return jtypes.EnvState(
        key=jax.random.split(jax.random.PRNGKey(0), n),
        **{f.name: jnp.asarray(getattr(es, f.name).numpy())
           for f in dataclasses.fields(EnvState)})


def _close(got, want, rtol):
    for k in ("eval_return_mean", "eval_return_std"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=0, err_msg=k)
    for k in ("eval_length_mean", "eval_goal_rate", "eval_collision_rate",
              "eval_done_all"):
        assert float(got[k]) == float(want[k]), k


@pytest.mark.parametrize("policy", ["flagship", "circling"])
def test_solo_float32_matches_the_jax_eval(policy):
    params = _flagship() if policy == "flagship" else _circling_policy(3)
    gen = torch.Generator().manual_seed(11)
    es, obs = vector.reset_batch(6, DEFAULT_PARAMS, gen, torch.float32, "cpu")
    got = learner.eval_metrics(
        learner.GreedyEval(device="cpu")(params, es, obs, DEFAULT_PARAMS))
    want = _jax_greedy(6)(flat_to_tree(params), _jax_state(es),
                          jnp.asarray(obs.numpy()))
    _close(got, want, 1e-5)
    assert float(want["eval_length_mean"]) == (
        1000.0 if policy == "circling" else pytest.approx(657.6667, abs=1e-3))


def test_exact_float64_matches_the_jax_exact_eval():
    params = _flagship()
    got = learner.make_exact_eval_fn(
        PPOConfig(eval_episodes=8), DEFAULT_PARAMS, dtype=torch.float64,
        device="cpu", skip_episodes=2)(params)
    want = jlearner.make_exact_eval_fn(
        JActorCritic(), JPPOConfig(eval_episodes=8), JP, dtype=jnp.float64,
        skip_episodes=2)(flat_to_tree(params))
    assert got["eval_return_mean"].dtype == torch.float64
    _close(got, want, 1e-7)
    assert float(want["eval_goal_rate"]) == 1.0


def test_population_eval_matches_the_jax_eval_per_member():
    flag = _flagship()
    params = torch.stack([flag, _circling_policy(5)])
    n = 4
    em = population.make_population_eval(
        PPOConfig(eval_episodes=n), DEFAULT_PARAMS, device="cpu")(
        params, torch.Generator().manual_seed(2))
    # the eval's spawns: P * n from the generator, member m the m-th n
    es, obs = vector.reset_batch(2 * n, DEFAULT_PARAMS,
                                 torch.Generator().manual_seed(2),
                                 torch.float32, "cpu")
    run = _jax_greedy(n)
    for m in range(2):
        part = slice(m * n, (m + 1) * n)
        member = EnvState(**{f.name: getattr(es, f.name)[part]
                             for f in dataclasses.fields(EnvState)})
        want = run(flat_to_tree(params[m]), _jax_state(member),
                   jnp.asarray(obs[part].numpy()))
        _close({k: v[m] for k, v in em.items()}, want, 1e-5)
    assert em["eval_length_mean"][1] == 1000.0       # the circling member
