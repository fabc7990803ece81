"""The port's population training (ppo/population.py, and the
--population path of `python -m acas2d_tpu_torch.train`) vs the JAX
package's, float32 on the CPU.

* One whole population step (member-grid rollout -> GAE -> packed update)
  against `acas2d_tpu.ppo.population.make_population_step` with
  fused_rollout + fused_update_packed at the shape of
  tests/test_population_fused_rollout.py:123-125: P = 2, 1024 envs x 8
  steps in chunks of 4, minibatch 2048, 1 epoch.  Both start from the same
  params and env state (episodes part-way through, so timeouts end some);
  the port receives the rollout seed and each member's permutations that
  the JAX step derives from its keys (population.py:159-162, 250-256;
  learner.py:440, 460).  The JAX step runs its kernels in interpret mode;
  the port the plain versions of its kernels.  Tolerances are the solo
  slice test's (tests/test_torch_slice.py): episode counts and outcome
  rates exactly, returns and lengths rtol 1e-5, losses rtol 1e-4, params
  atol 2e-6.
* `init_population` member i against the solo init with seed + i.
* `PopulationTracker` against the JAX tracker on one eval sequence: the
  same population.json and bit-equal npz contents; and the deliberate
  divergence on a NaN re-eval (ADVICE.md, first finding).
* `acas2d_tpu_torch.train` with --population 2 --device cpu at a tiny
  shape, with one polish round: its artifacts load in the JAX
  `load_params_npz` and the port's exact eval.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ppo import population as jpopulation
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
from acas2d_tpu.utils.params_io import load_params_npz as jload_params_npz
from acas2d_tpu_torch import eval as teval
from acas2d_tpu_torch import train
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.models.actor_critic import N_PARAMS
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils.params_io import (flat_to_tree, load_flat_params,
                                              tree_to_flat)

POP = 2
SHAPE = dict(n_envs=1024, n_steps=8, fused_chunk=4, minibatch_size=2048,
             total_timesteps=1024 * 8, n_epochs=1, fused_rollout=True,
             fused_update=True, fused_update_packed=True, seed=5)
PARAM_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def steps():
    jcfg, cfg = JPPOConfig(**SHAPE), PPOConfig(**SHAPE)
    model = JActorCritic()
    js = jpopulation.init_population(model, jcfg, JP, POP)
    mid = np.random.default_rng(0).integers(1, JP.max_steps + 1,
                                            (POP, jcfg.n_envs))
    js = js.replace(env_state=js.env_state.replace(
        steps=jnp.asarray(mid, jnp.int32)))
    jnew, jm = jax.jit(jpopulation.make_population_step(model, jcfg, JP))(js)

    # the draws the JAX step makes from its keys
    keys = jax.vmap(jax.random.split)(js.key)
    seed = int(jax.random.randint(keys[0, 1], (), 0,
                                  jnp.iinfo(jnp.int32).max, jnp.int32))
    n_blocks = cfg.batch_size // cfg.shuffle_block
    member_perms = []
    for m in range(POP):
        _, k_update = jax.random.split(keys[m, 0])
        member_perms.append([np.asarray(jax.random.permutation(k, n_blocks))
                             for k in jax.random.split(k_update,
                                                       cfg.n_epochs)])
    perms = [np.stack([member_perms[m][e] for m in range(POP)])
             for e in range(cfg.n_epochs)]

    es = js.env_state
    env_state = EnvState(**{f: _t(getattr(es, f)) for f in (
        "px", "py", "ppsi", "pa_lat", "tx", "ty", "tv", "tpsi",
        "num_traffic", "steps", "total_reward", "outcome")})
    params = tree_to_flat(jax.tree.map(np.asarray, js.params), n_lead=1)
    state = population.PopulationState(
        params=params, opt_state=learner.Optimizer(cfg).init(params),
        env_state=env_state, obs=_t(js.obs),
        generators=[torch.Generator() for _ in range(POP)])
    phases = []
    step = population.make_population_step(cfg, TP, device="cpu",
                                           on_phase=phases.append)
    new, m = step(state, seed=seed, perms=perms)
    return jnew, jax.tree.map(np.asarray, jm), new, m, phases


def test_population_step_metrics_match(steps):
    jnew, jm, new, m, phases = steps
    assert phases == ["rollout", "gae", "update"]
    assert (jm["episodes"] > 0).all(), "the shape should end some episodes"
    for k in ("episodes", "goal_rate", "collision_rate", "timeout_rate"):
        assert m[k].shape == (POP,)
        np.testing.assert_array_equal(m[k].numpy(), jm[k], err_msg=k)
    # episodes that time out right after the mid-episode start earn almost
    # nothing (their time discount is ~0), so a member's mean return can be
    # ~1e-4: atol 1e-7 covers float32 rounding of such sums
    for k in ("ep_return_mean", "ep_length_mean"):
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in ("policy_loss", "value_loss", "entropy", "approx_kl",
              "clip_fraction", "loss", "explained_variance"):
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert new.iteration == 1 and (np.asarray(jnew.iteration) == 1).all()


def test_population_step_params_and_env_state_match(steps):
    jnew, jm, new, m, _ = steps
    want = tree_to_flat(jax.tree.map(np.asarray, jnew.params),
                        n_lead=1).numpy()
    assert new.params.shape == (POP, N_PARAMS)
    np.testing.assert_allclose(new.params.numpy(), want, rtol=0,
                               atol=PARAM_ATOL)
    assert new.opt_state.count == 4                 # 1 epoch x 4 minibatches
    np.testing.assert_array_equal(new.env_state.steps.numpy(),
                                  np.asarray(jnew.env_state.steps))
    np.testing.assert_array_equal(new.env_state.outcome.numpy(), 0)


def test_init_population_members_are_solo_inits():
    cfg = PPOConfig(n_envs=16, n_steps=8, seed=21)
    st = population.init_population(cfg, TP, 3, device="cpu")
    assert st.params.shape == (3, N_PARAMS) and st.obs.shape == (3, 16, 8)
    for i in range(3):
        solo = learner.init_train_state(cfg, TP, "cpu", seed=cfg.seed + i)
        assert torch.equal(st.params[i], solo.params)
        assert torch.equal(st.opt_state.mu[i], solo.opt_state.mu)
        assert torch.equal(st.obs[i], solo.obs)
        for f in ("px", "ppsi", "tx", "tpsi", "steps", "num_traffic"):
            assert torch.equal(getattr(st.env_state, f)[i],
                               getattr(solo.env_state, f)), f
        # each member continues its own generator
        assert torch.equal(st.generators[i].get_state(),
                           solo.generator.get_state())
    assert not torch.equal(st.params[0], st.params[1])


def test_optimizer_clips_each_member_by_its_own_norm():
    cfg = PPOConfig()
    opt = learner.Optimizer(cfg)
    g = torch.randn(2, N_PARAMS, generator=torch.Generator().manual_seed(0))
    g[0] *= 1e-4                                  # under max_grad_norm
    state = opt.init(torch.zeros(2, N_PARAMS))
    up, _ = opt.update(g, state)
    for m in range(2):
        solo, _ = opt.update(g[m], opt.init(torch.zeros(N_PARAMS)))
        torch.testing.assert_close(up[m], solo, rtol=1e-6, atol=0)


def test_params_io_round_trips():
    """flax tree <-> state_dict <-> flat vector, with and without leading
    axes, and the JAX packed 7-leaf tree -> flat layout."""
    from acas2d_tpu.ops import pallas_update
    from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
    from acas2d_tpu_torch.utils.params_io import (from_jax_params,
                                                  packed_to_flat,
                                                  to_jax_params)
    trees = [jax.tree.map(np.asarray, JActorCritic().init(
        jax.random.PRNGKey(s), jnp.zeros((1, 8), jnp.float32)))
        for s in range(3)]
    for tree in trees:
        sd = from_jax_params(tree)
        back = to_jax_params(sd)
        assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, tree)
        jax.tree.map(np.testing.assert_array_equal, back, tree)
        model = ActorCritic()
        model.load_state_dict(sd)
        assert torch.equal(tree_to_flat(tree), flatten(model))
        jax.tree.map(np.testing.assert_array_equal,
                     flat_to_tree(flatten(model)), tree)
        flat, off = packed_to_flat(pallas_update.pack_params_tree(tree))
        np.testing.assert_array_equal(flat, flatten(model).numpy())
        assert np.all(off == 0.0)
    stacked = jax.tree.map(lambda *x: np.stack(x), *trees)
    flat = tree_to_flat(stacked, n_lead=1)
    assert flat.shape == (3, N_PARAMS)
    jax.tree.map(np.testing.assert_array_equal, flat_to_tree(flat), stacked)
    for i, tree in enumerate(trees):
        assert torch.equal(flat[i], tree_to_flat(tree))


# ------------------------------------------------------------------ tracker

def _eval_sequence(pop=3, k=2, n_evals=4, seed=0):
    rng = np.random.default_rng(seed)
    for e in range(n_evals):
        vals = rng.normal(size=pop).astype(np.float32) * 100 + 1000
        params = rng.normal(size=(pop, N_PARAMS)).astype(np.float32)
        yield (e + 1) * 4096, vals, params


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _run_trackers(tmp_path, reval=None, reval_std=None, pop=3, k=2):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jt = jpopulation.PopulationTracker(str(jdir), pop, 7, k=k,
                                       save_interval_s=0.0)
    tt = population.PopulationTracker(str(tdir), pop, 7, k=k,
                                      save_interval_s=0.0)
    for gstep, vals, params in _eval_sequence(pop, k):
        assert (jt.update(gstep, vals, flat_to_tree(params))
                == tt.update(gstep, vals, params))
        a, b = _npz(jdir / "population_best.npz"), _npz(
            tdir / "population_best.npz")
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    js = jt.finalize(reval, reval_episodes=64, reval_stds=reval_std)
    ts = tt.finalize(reval, reval_episodes=64, reval_stds=reval_std)
    return jdir, tdir, js, ts, tt


@pytest.mark.parametrize("with_reval", [False, True])
def test_tracker_matches_jax_tracker(tmp_path, with_reval):
    pop, k = 3, 2
    rng = np.random.default_rng(5)
    reval = (rng.normal(size=pop * k) * 50 + 1100) if with_reval else None
    stds = (rng.uniform(50, 400, size=pop * k)) if with_reval else None
    jdir, tdir, js, ts, tt = _run_trackers(tmp_path, reval, stds)
    assert ts == js
    with open(jdir / "population.json") as f1, \
            open(tdir / "population.json") as f2:
        assert json.load(f1) == json.load(f2)
    for name in ("selected_best.npz", "top_snapshots.npz"):
        a, b = _npz(jdir / name), _npz(tdir / name)
        assert a.keys() == b.keys(), name
        for key in a:
            assert a[key].dtype == b[key].dtype, (name, key)
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # a fresh tracker in the same run dir reads the archive back
    again = population.PopulationTracker(str(tdir), pop, 7, k=k)
    np.testing.assert_array_equal(again.snap_vals, tt.snap_vals)
    np.testing.assert_array_equal(again.snap_steps, tt.snap_steps)
    np.testing.assert_array_equal(again.snapshots_flat()[0],
                                  tt.snapshots_flat()[0])


def test_tracker_never_selects_a_nan_reval(tmp_path):
    """Deliberate divergence from the JAX tracker (ADVICE.md, first
    finding): a NaN re-eval of a claimed snapshot hijacks the JAX argmax
    and tops its ranking; the port masks non-finite scores to -inf."""
    pop, k = 3, 2
    reval = np.full(pop * k, 1000.0)
    reval[1] = 1100.0                       # the best finite score
    reval[4] = np.nan                       # member 2, slot 0: claimed
    stds = np.full(pop * k, 100.0)
    js, ts = _run_trackers(tmp_path, reval, stds)[2:4]
    assert (js["selected_member"], js["top_snapshots"][0]["member"]) == (2, 2)
    assert ts["selected_member"] == 0 and ts["top_snapshots"][0] == {
        "member": 0, "slot": 1, "rank_value": 1080.0}
    assert all(t["member"] != 2 or t["slot"] != 0
               for t in ts["top_snapshots"])
    assert ts["selected_score"] == 1080.0


# ------------------------------------------------------------------ driver

TINY = ["--preset", "tpu", "--device", "cpu", "--n-envs", "64",
        "--n-steps", "16", "--minibatch-size", "512", "--n-epochs", "2",
        "--eval-episodes", "3", "--reval-episodes", "4", "--anneal-lr",
        "--fused-rollout", "--fused-update-packed"]


def test_population_driver_writes_jax_readable_artifacts(tmp_path, capsys):
    argv = TINY + ["--population", "2", "--total-steps", str(2 * 64 * 16),
                   "--polish-steps", str(64 * 16), "--polish-pop", "3",
                   "--out-dir", str(tmp_path), "--run-name", "pop"]
    rows = train.run(train.parse_args(argv))
    assert len(rows) == 3                      # 2 iterations + 1 of polish
    assert [r["global_step"] for r in rows] == [1024, 2048, 1024]
    assert len(rows[0]["eval_return_members"]) == 2
    assert len(rows[2]["eval_return_members"]) == 3
    assert rows[0]["steps_per_s"] > 0
    jtree = JActorCritic().init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.float32))
    for stage, pop in (("pop", 2), ("pop_polish", 3)):
        run_dir = tmp_path / stage
        with open(run_dir / "population.json") as f:
            summary = json.load(f)
        # the polish stage's record gains the pipeline-level keys (JAX
        # scripts/population_merge.py); summary.json keeps the stage's own
        merged = summary.pop("stage1", None), summary.pop("pipeline", None)
        if stage == "pop_polish":
            with open(tmp_path / "pop" / "population.json") as f:
                assert merged[0] == json.load(f)
            assert merged[1] == ["stage1_population2_rollpacked",
                                 "reval4_risk_adjusted", "polish_population3"]
        else:
            assert merged == (None, None)
        assert summary["population"] == pop
        assert summary["selected_by"] == "final_reval"
        assert summary["risk_adjusted_selection"] is True
        with open(run_dir / "summary.json") as f:
            assert json.load(f)["population_selection"] == summary
        sel = jload_params_npz(str(run_dir / "selected_best.npz"))
        assert (jax.tree.map(np.shape, sel)
                == jax.tree.map(np.shape, jax.tree.map(np.asarray, jtree)))
        top = jload_params_npz(str(run_dir / "top_snapshots.npz"))
        n_top = int(top.pop("__stack_n__"))
        assert n_top == min(3, pop)
        flat, stack_n = load_flat_params(str(run_dir / "top_snapshots.npz"))
        assert stack_n == n_top and flat.shape == (n_top, N_PARAMS)
        res = teval.run(teval.parse_args(
            ["--params-npz", str(run_dir / "selected_best.npz"), "--exact",
             "--episodes", "2", "--out", str(run_dir / "eval_2.csv"),
             "--device", "cpu"]))
        assert res["episodes"] == 2 and np.isfinite(res["mean_reward"])
    err = capsys.readouterr().err
    assert "round-robin from 2 lineages" in err     # the polish warm start


def test_population_driver_refuses_exact_eval():
    with pytest.raises(ValueError, match="single-policy"):
        train.run(train.parse_args(TINY + ["--population", "2",
                                           "--exact-eval"]))


def test_solo_packed_update_is_the_fused_update(capsys, tmp_path):
    """--fused-update-packed trains the solo run exactly as the fused
    update: the port's parameters are always the kernel's flat layout."""
    base = ["--preset", "tpu", "--fused-rollout", "--fused-update",
            "--device", "cpu", "--n-envs", "32",
            "--n-steps", "16", "--minibatch-size", "256", "--n-epochs", "1",
            "--total-steps", str(32 * 16), "--eval-episodes", "2",
            "--out-dir", str(tmp_path)]
    timing = ("steps_per_s", "seconds", "eval_seconds")
    rows = [{k: v for k, v in r.items() if k not in timing}
            for flags in ([], ["--fused-update-packed"])
            for r in train.run(train.parse_args(base + flags))]
    assert rows[0] == rows[1]
