"""The port's member-grid rollout (plain version,
ops/policy_rollout.py:fused_policy_rollout_members) vs the Pallas kernel
`acas2d_tpu/ops/pallas_policy.py:fused_policy_rollout_members` in interpret
mode: P = 2 members with different weights (carried across with
`from_jax_params`), B = 1024 envs each, K = 4 steps, the same seed, episodes
part-way through so that timeouts respawn inside the launch.

The member grid numbers env e of member m as the global env m * B + e in
both packages, so every sample and respawn matches.  Tolerances are the
solo test's (tests/test_torch_policy_rollout.py), for its reasons: float32
dot products summed in another order, angle features compared modulo 1,
at most 1% of envs whose policy saw a wrapped angle excluded from the
continuous comparisons, integer buffers exact.

Port-internal: the solo wrapper is the P = 1 call bit for bit, member 0 of
a launch draws the solo streams, and a second member with the same
weights and state draws other noise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.envs import vector as jvector
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ops import pallas_policy
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.ops.policy_rollout import (fused_policy_rollout,
                                                 fused_policy_rollout_members)
from acas2d_tpu_torch.utils.params_io import tree_to_flat

P, B, K, SEED, OFFSET = 2, pallas_policy.E, 4, 11, 8
ATOL = 2e-6             # x max|field|, as the solo test
REWARD_ATOL = 5e-5
SUM_FIELDS = ("episode_return", "total_reward")
ANGLE_FEATURES = (1, 4)
MAX_WRAPPED = 0.01
KEYS = ("px", "py", "psi", "tx", "ty", "tv", "tpsi", "steps", "total_reward")


def _jax_inputs():
    jmodel = JActorCritic()
    members = []
    for m in range(P):
        jp = jmodel.init(jax.random.PRNGKey(10 + m),
                         jnp.zeros((1, 8), jnp.float32))
        members.append({"params": {**jp["params"], "log_std": jnp.full(
            (1,), -0.5 - 0.2 * m, jnp.float32)}})
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *members)
    s, obs = jvector.reset_batch(jax.random.PRNGKey(7), P * B, JP,
                                 jnp.float32)
    steps = np.random.default_rng(0).integers(1, JP.max_steps + 1, P * B)
    state = dict(px=s.px, py=s.py, psi=s.ppsi, tx=s.tx[:, 0], ty=s.ty[:, 0],
                 tv=s.tv[:, 0], tpsi=s.tpsi[:, 0],
                 steps=steps.astype(np.int32),
                 total_reward=np.zeros(P * B, np.float32))
    state = {k: np.asarray(v).reshape(P, B) for k, v in state.items()}
    return stacked, state, np.asarray(obs, np.float32).reshape(P, B, 8)


@pytest.fixture(scope="module")
def runs():
    stacked, state, obs = _jax_inputs()
    jst, jbuf = pallas_policy.fused_policy_rollout_members(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(obs),
        stacked, SEED, OFFSET, K, JP, interpret=True)
    jst = {k: np.asarray(v) for k, v in jst.items()}
    jbuf = {k: np.asarray(v) for k, v in jbuf.items()}   # (P, K, B, ...)

    params = tree_to_flat(jax.tree.map(np.asarray, stacked), n_lead=1)
    tst, tbuf = fused_policy_rollout_members(
        {k: torch.tensor(v) for k, v in state.items()},
        torch.tensor(obs), params, SEED, OFFSET, K, TP)
    tst = {k: v.numpy() for k, v in tst.items()}
    # the port's buffers are time-major (K, P, B): compare member-major
    tbuf = {k: np.moveaxis(v.numpy(), 1, 0) for k, v in tbuf.items()}
    return jst, jbuf, tst, tbuf, params


def _close(got, want, name, field=""):
    atol = (REWARD_ATOL if field == "rewards"
            else 2 * K * REWARD_ATOL if field in SUM_FIELDS
            else ATOL * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def _wrap_dist(a, b):
    d = np.abs(a - b) % 1.0
    return np.minimum(d, 1.0 - d)


def test_member_buffers_match_pallas(runs):
    jst, jbuf, tst, tbuf, _ = runs
    assert set(jbuf) == set(tbuf)
    for k in ("dones", "outcome", "episode_steps"):
        np.testing.assert_array_equal(tbuf[k], jbuf[k], err_msg=k)
    assert int(jbuf["dones"].sum()) > 0, "the launch should respawn envs"
    for m in range(P):
        wrapped = np.zeros(B, bool)
        for t in range(K):
            to, jo = tbuf["obs"][m, t], jbuf["obs"][m, t]
            for f in ANGLE_FEATURES:
                np.testing.assert_allclose(
                    _wrap_dist(to[~wrapped, f], jo[~wrapped, f]), 0,
                    atol=ATOL, err_msg=f"member {m} angle {f}")
            for f in ANGLE_FEATURES:
                wrapped |= np.abs(to[:, f] - jo[:, f]) > 0.5
            keep = ~wrapped
            other = [f for f in range(8) if f not in ANGLE_FEATURES]
            _close(to[keep][:, other], jo[keep][:, other], f"obs m={m} t={t}")
            for k in ("actions", "log_probs", "values", "rewards",
                      "episode_return"):
                _close(tbuf[k][m, t][keep], jbuf[k][m, t][keep],
                       f"member {m} {k} t={t}", k)
        assert wrapped.mean() <= MAX_WRAPPED, (m, wrapped.mean())


def test_member_final_state_matches_pallas(runs):
    jst, jbuf, tst, tbuf, _ = runs
    np.testing.assert_array_equal(tst["steps"], jst["steps"])
    wrapped = (np.abs(tbuf["obs"][..., list(ANGLE_FEATURES)]
                      - jbuf["obs"][..., list(ANGLE_FEATURES)]) > 0.5
               ).any(axis=(1, 3))                       # (P, B)
    keep = ~wrapped
    for k in ("px", "py", "psi", "tx", "ty", "tv", "tpsi", "total_reward",
              "pa_lat"):
        _close(tst[k][keep], jst[k][keep], k, k)
    for f in range(8):
        a, b = tst["obs"][..., f][keep], jst["obs"][..., f][keep]
        if f in ANGLE_FEATURES:
            np.testing.assert_allclose(_wrap_dist(a, b), 0, atol=ATOL)
        else:
            _close(a, b, f"obs {f}")


def test_members_use_their_own_weights(runs):
    """The two members' weights differ, and so do their stored values on
    the same step (the launch does not mix members)."""
    _, _, _, tbuf, params = runs
    assert not torch.equal(params[0], params[1])
    assert not np.allclose(tbuf["values"][0], tbuf["values"][1])


def _port_inputs():
    """Member 0's weights, envs and observations."""
    stacked, state, obs = _jax_inputs()
    params = tree_to_flat(jax.tree.map(np.asarray, stacked), n_lead=1)
    st = {k: torch.tensor(v[0]) for k, v in state.items()}
    return st, torch.tensor(obs[0]), params[0]


def test_solo_is_the_p1_member_call_bit_for_bit():
    st, obs, params = _port_inputs()
    solo = fused_policy_rollout(st, obs, params, SEED, OFFSET, K, TP)
    mem = fused_policy_rollout_members(
        {k: v[None] for k, v in st.items()}, obs[None], params[None], SEED,
        OFFSET, K, TP)
    for part_solo, part_mem, lead in ((solo[0], mem[0], 0),
                                      (solo[1], mem[1], 1)):
        assert set(part_solo) == set(part_mem)
        for k, v in part_solo.items():
            assert torch.equal(v, part_mem[k].select(lead, 0)), k


def test_member_zero_draws_the_solo_streams_and_member_one_others():
    """Member 0's envs are the global envs 0..B-1, so with member 0's
    weights a 2-member launch reproduces the solo launch on member 0 bit for
    bit; member 1 with the SAME weights and state draws other noise."""
    st, obs, params = _port_inputs()
    solo_st, solo_buf = fused_policy_rollout(st, obs, params, SEED, 0, K, TP)
    two = {k: torch.stack([v, v]) for k, v in st.items()}
    mst, mbuf = fused_policy_rollout_members(
        two, torch.stack([obs, obs]), torch.stack([params, params]), SEED, 0,
        K, TP)
    for k, v in solo_buf.items():
        assert torch.equal(v, mbuf[k][:, 0]), k
    for k, v in solo_st.items():
        assert torch.equal(v, mst[k][0]), k
    a0, a1 = mbuf["actions"][:, 0], mbuf["actions"][:, 1]
    assert not torch.allclose(a0, a1)
    assert abs(float(a0.mean() - a1.mean())) < 0.1
