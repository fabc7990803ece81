"""The member-sharded population (acas2d_tpu_torch/ppo/population.py with a
`parallel.mesh.Mesh`): P = 4 members on two gloo ranks, two a rank, with no
collective in a step (JAX shard_maps the member axis,
population.py:269-273).

One launch of two ranks runs `parallel/dryrun.py`'s population variants for
two iterations; the tests hold them against one process:

  * unfused (step-by-step rollout, autograd update): the whole gathered
    state (params, Adam moments, envs, obs, every generator) and every
    member's metrics equal the single-process run's bit for bit, since the
    rollout's draws are hashed by the global member index from member 0's
    seed and each member's permutations come from its own generator;
  * fused (member-grid rollout, fused update): rank r's first rollout
    chunk equals one launch of the plain kernel on its members' rows at
    the seed of its first member's generator + 7919 r, and its members
    after two iterations equal a single-process run of those members given
    the same seeds and permutations, bit for bit."""

import argparse
import dataclasses
import os
import sys

import pytest
import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.ops.policy_rollout import fused_policy_rollout_members
from acas2d_tpu_torch.parallel import dryrun, launch, mesh as mesh_lib
from acas2d_tpu_torch.ppo import learner, population

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
W, POP, ENVS, N_STEPS, CHUNK, ITERS = 2, 4, 16, 16, 8, 2
SHAPE = dict(envs_per_rank=ENVS, n_steps=N_STEPS, minibatch=64, epochs=2,
             chunk=CHUNK, pop=POP, pop_envs=ENVS)


def _worker(out: str) -> None:
    torch.set_num_threads(1)
    mesh = mesh_lib.multihost_init("cpu")
    args = argparse.Namespace(out=out, dtype="float32", iters=ITERS,
                              pop_iters=0, pop_minibatch=0, **SHAPE)
    for name in ("population", "population_fused"):
        dryrun.run_variant(name, args, mesh)


def _config(name):
    return dryrun.variant_config(name, W, SHAPE["envs_per_rank"], N_STEPS,
                                 SHAPE["minibatch"], SHAPE["epochs"], CHUNK,
                                 POP, ENVS)


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # the ranks' (OMP_NUM_THREADS=1)
    try:
        d = str(tmp_path_factory.mktemp("sharded_population"))
        launch.check_ranks(launch.run_ranks(
            ["-m", "tests.test_torch_sharded_population", "worker", d], W,
            JOIN_S, cwd=ROOT))
        yield d
    finally:
        torch.set_num_threads(n)


def _load(out, name):
    return torch.load(os.path.join(out, name), weights_only=False)


def _assert_states_equal(a, b, members=slice(None)):
    assert a["iteration"] == b["iteration"]
    assert a["adam"]["count"] == b["adam"]["count"]
    assert torch.equal(a["params"], b["params"][members])
    for k in ("mu", "nu"):
        assert torch.equal(a["adam"][k], b["adam"][k][members]), k
    for k, v in a["env_state"].items():
        assert torch.equal(v, b["env_state"][k][members]), k
    assert torch.equal(a["obs"], b["obs"][members])


def test_unfused_population_on_two_ranks_is_one_process_bit_for_bit(out):
    got = _load(out, "population.pt")
    assert got["sharded"] and got["world"] == W
    cfg, pop = _config("population")
    state = dryrun.init_state(cfg, pop, "cpu")
    step = dryrun.make_step(cfg, pop, "cpu")
    for row in got["metrics"]:
        state, m = step(state)
        assert set(m) == set(row)
        for k, v in m.items():
            assert torch.equal(row[k], v), k
    one = learner.state_to_dict(state)
    _assert_states_equal(got["state"], one)
    assert all(torch.equal(a, b) for a, b in
               zip(got["state"]["generators"], one["generators"]))


def _draws(cfg, state, seed_gens):
    """The next iteration's seeds and permutations of `state`, drawn from
    copies of its generators."""
    gens = []
    for g in state.generators:
        gens.append(torch.Generator())
        gens[-1].set_state(g.get_state())
    seeds, perms, _ = learner.iteration_inputs(
        cfg, state.replace(generators=gens), 1, "cpu", seed_gens=seed_gens)
    return seeds[0], perms[0], gens


def _members(state, rows):
    return state.replace(
        params=state.params[rows], opt_state=dataclasses.replace(
            state.opt_state, mu=state.opt_state.mu[rows],
            nu=state.opt_state.nu[rows]),
        env_state=mesh_lib.map_tensors(state.env_state, lambda x: x[rows]),
        obs=state.obs[rows], generators=state.generators[rows])


@pytest.mark.parametrize("rank", range(W))
def test_fused_rank_chunk_is_the_kernel_at_its_folded_seed(out, rank):
    cfg, pop = _config("population_fused")
    state = dryrun.init_state(cfg, pop, "cpu")
    first = rank * POP // W
    seeds, _, _ = _draws(cfg, state, (0, POP // W))
    seed = mesh_lib.fold_seed(int(seeds[rank]),
                              mesh_lib.Mesh(rank, W, object(), "cpu"))
    got = _load(out, f"population_fused_chunk{rank}.pt")
    assert got["seed"] == seed
    mine = _members(state, slice(first, first + POP // W))
    es = mine.env_state
    flat = dict(px=es.px, py=es.py, psi=es.ppsi, tx=es.tx[..., 0],
                ty=es.ty[..., 0], tv=es.tv[..., 0], tpsi=es.tpsi[..., 0],
                steps=es.steps, total_reward=es.total_reward)
    _, buf = fused_policy_rollout_members(flat, mine.obs, mine.params, seed,
                                          0, CHUNK, TP)
    assert torch.equal(got["obs"], buf["obs"])
    assert torch.equal(got["actions"][..., 0], buf["actions"])
    for k in ("log_probs", "values", "rewards"):
        assert torch.equal(got[k], buf[k]), k
    assert torch.equal(got["dones"], buf["dones"] > 0)


def test_fused_rank_trains_its_members_as_one_process(out):
    """Rank r's step is a one-process step of its members given its folded
    seed and its members' permutations."""
    got = _load(out, "population_fused.pt")
    cfg, pop = _config("population_fused")
    whole = dryrun.init_state(cfg, pop, "cpu")
    step = population.make_population_step(cfg, TP, "cpu")
    k = POP // W
    subs = [_members(whole, slice(r * k, (r + 1) * k)) for r in range(W)]
    for i in range(ITERS):
        seeds, perms, gens = _draws(cfg, whole, (0, k))
        whole = whole.replace(generators=gens)
        for r in range(W):
            seed = mesh_lib.fold_seed(int(seeds[r]),
                                      mesh_lib.Mesh(r, W, object(), "cpu"))
            subs[r], m = step(subs[r], seed=seed,
                              perms=perms[:, r * k:(r + 1) * k])
            for key, v in m.items():
                assert torch.equal(got["metrics"][i][key][r * k:(r + 1) * k],
                                   v), key
    for r in range(W):
        _assert_states_equal(learner.state_to_dict(subs[r]), got["state"],
                             slice(r * k, (r + 1) * k))
    assert all(torch.equal(g.get_state(), h) for g, h in
               zip(whole.generators, got["state"]["generators"]))


if __name__ == "__main__":
    _worker(sys.argv[2])
