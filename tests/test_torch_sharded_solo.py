"""The env-sharded solo learner on two gloo ranks (acas2d_tpu_torch/ppo/
learner.py with a `parallel.mesh.Mesh`) against the single-process port and
against the JAX package's `shard_map` paths on a 2-device mesh.

One launch of two ranks (`python -m tests.test_torch_sharded_solo worker
DIR`) runs every case and writes its outputs; the tests compare them:

  * the unfused pair (step-by-step rollout, autograd update), 2 iterations,
    against one process: float64 within 1e-12, float32 within JAX's own
    tolerance for a sharded step (tests/test_sharding.py:81-87, rtol 1e-4,
    atol 1e-5); the fused update on the step-by-step rollout within JAX's
    tolerance for the fused update (tests/test_sharding.py:115-121).  The
    unfused rollout's draws are the single process's rows, so its env
    state starts the same and differs only by the update's sum order;
  * the fused gradients of one minibatch, normalised whole as the update
    normalises it, split 128 rows a rank and averaged, against JAX
    `make_fused_grads_fn(cfg, mesh)` (Pallas in interpret mode under
    `shard_map` with `pmean`) on the same params and minibatch, each
    block within 1e-5 of its largest entry
    (tests/test_torch_ppo_grads.py's bound);
  * the fused rollout of 1024 envs a rank, the seed folded by rank,
    against JAX `collect_rollout_fused(..., mesh=<2 devices>)` with the
    same seed, within tests/test_torch_policy_rollout.py's tolerance, and
    the episode metrics summed over the ranks.

In-process: the fused update refuses a minibatch whose rank's rows are not
a multiple of 128, as JAX's does (tests/test_sharding.py:124)."""

import argparse
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.ops import ppo_grads
from acas2d_tpu_torch.parallel import dryrun, launch, mesh as mesh_lib
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.ppo.config import PPOConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
W = 2
ITERS = 2
# dryrun shapes: (variant, dtype, envs a rank, minibatch, epochs)
UNFUSED = (("xla", "float64", 8, 64, 10), ("xla", "float32", 8, 64, 10),
           ("fused_update", "float32", 32, 256, 2))
N_STEPS = 32
ROLL = dict(n_envs=2048, n_steps=8, fused_rollout=True, fused_chunk=4,
            minibatch_size=2048, n_epochs=1, total_timesteps=2048 * 8)
GRADS = dict(n_envs=2, n_steps=128, minibatch_size=256, total_timesteps=256,
             fused_update=True)
GRAD_REL_TOL = 1e-5
ATOL = 2e-6           # tests/test_torch_policy_rollout.py's
REWARD_ATOL = 5e-5
ANGLE_FEATURES = (1, 4)
MAX_WRAPPED = 0.01


def _dryrun_args(out, dtype, envs, minibatch, epochs):
    return argparse.Namespace(out=out, dtype=dtype, iters=ITERS, pop_iters=0,
                              pop_minibatch=0, envs_per_rank=envs, n_steps=N_STEPS,
                              minibatch=minibatch, epochs=epochs, chunk=8,
                              pop=4, pop_envs=8)


def _worker(out: str) -> None:
    torch.set_num_threads(1)
    mesh = mesh_lib.multihost_init("cpu")
    for name, dtype, envs, mb, epochs in UNFUSED:
        d = os.path.join(out, f"{name}_{dtype}")
        os.makedirs(d, exist_ok=True)
        dryrun.run_variant(name, _dryrun_args(d, dtype, envs, mb, epochs),
                           mesh)
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    r = mesh.rank
    # the fused gradients of one minibatch, normalised whole, then split
    # over the ranks
    g = inputs["grads"]
    grads, aux = learner.minibatch_grads_fn(PPOConfig(**GRADS), mesh)(
        g["params"][None], ppo_grads.normalize_adv_column(g["mb"][None]))
    # the fused rollout of this rank's rows, the seed folded by rank
    ro = inputs["rollout"]
    rows = mesh_lib.env_rows(ROLL["n_envs"], mesh)
    state = learner.TrainState(
        params=ro["params"], opt_state=learner.Optimizer(
            PPOConfig(**ROLL)).init(ro["params"]),
        env_state=mesh_lib.shard_env_state(ro["env_state"], mesh),
        obs=ro["obs"][rows].clone(), generator=torch.Generator())
    new, batch, last, metrics = learner.collect_rollout_fused(
        state, PPOConfig(**ROLL), TP,
        mesh_lib.fold_seed(ro["seed"], mesh), mesh)
    torch.save({"grads": grads, "aux": aux,
                "batch": dataclasses.asdict(batch), "metrics": metrics,
                "obs": new.obs, "px": new.env_state.px},
               os.path.join(out, f"rank{r}.pt"))


# ----------------------------------------------------------------- parent

def _jax_inputs():
    """The JAX side of the fused cases and the port's copy of its inputs."""
    import jax
    import jax.numpy as jnp

    from acas2d_tpu.config import DEFAULT_PARAMS as JP
    from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
    from acas2d_tpu.models.actor_critic import gaussian_log_prob as jlogp
    from acas2d_tpu.parallel import mesh as jmesh
    from acas2d_tpu.ppo import learner as jlearner
    from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
    from test_torch_unfused_rollout import env_of, flat_of

    m2 = jmesh.make_mesh(jax.devices()[:W])
    model = JActorCritic()
    # one minibatch whose ratios straddle the clip band
    jp = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.float32))
    rng = np.random.default_rng(5)
    n = GRADS["minibatch_size"]
    obs = rng.normal(size=(n, 8)).astype(np.float32) * 0.3
    mean, log_std, value = model.apply(jp, jnp.asarray(obs))
    act = np.asarray(mean) + rng.normal(size=(n, 1)).astype(np.float32) * 0.7
    old = np.asarray(jlogp(jnp.asarray(act), mean, log_std))
    old = old + rng.normal(size=n).astype(np.float32) * 0.3
    mb = np.concatenate([obs, act, old[:, None], np.asarray(value)[:, None],
                         rng.normal(size=(n, 2)).astype(np.float32) + 0.3],
                        axis=1).astype(np.float32)
    jgrads, jaux = jlearner.make_fused_grads_fn(JPPOConfig(**GRADS), m2)(
        jp, jnp.asarray(mb))
    # a fused rollout part-way through its episodes
    jcfg = JPPOConfig(**ROLL)
    js = jlearner.init_train_state(jax.random.PRNGKey(6), model, jcfg, JP)
    mid = np.random.default_rng(0).integers(1, JP.max_steps + 1,
                                            ROLL["n_envs"])
    js = js.replace(env_state=js.env_state.replace(
        steps=jnp.asarray(mid, jnp.int32)))
    jnew, jbatch, _, jm = jlearner.collect_rollout_fused(model, js, jcfg, JP,
                                                         mesh=m2)
    _, k_seed = jax.random.split(js.key)
    seed = int(jax.random.randint(k_seed, (), 0, jnp.iinfo(jnp.int32).max,
                                  jnp.int32))
    inputs = {"grads": {"params": flat_of(jp, torch.float32),
                        "mb": torch.tensor(mb)},
              "rollout": {"params": flat_of(js.params, torch.float32),
                          "env_state": env_of(js.env_state),
                          "obs": torch.tensor(np.asarray(js.obs)),
                          "seed": seed}}
    want = {"grads": flat_of(jgrads, torch.float32).numpy(),
            "aux": {k: float(v) for k, v in jaux.items()},
            "batch": {f.name: np.asarray(getattr(jbatch, f.name))
                      for f in dataclasses.fields(jbatch)},
            "metrics": {k: float(v) for k, v in jm.items()},
            "obs": np.asarray(jnew.obs), "px": np.asarray(jnew.env_state.px)}
    return inputs, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # the ranks' (OMP_NUM_THREADS=1)
    try:
        out = str(tmp_path_factory.mktemp("sharded_solo"))
        inputs, want = _jax_inputs()
        torch.save(inputs, os.path.join(out, "inputs.pt"))
        launch.check_ranks(launch.run_ranks(
            ["-m", "tests.test_torch_sharded_solo", "worker", out], W,
            JOIN_S, cwd=ROOT))
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False) for r in range(W)]
        singles = {}
        for name, dtype, envs, mb, epochs in UNFUSED:
            cfg, pop = dryrun.variant_config(name, W, envs, N_STEPS, mb,
                                             epochs, 8, 4, 8)
            dt = getattr(torch, dtype)
            state = dryrun.init_state(cfg, pop, "cpu", dt)
            step = dryrun.make_step(cfg, pop, "cpu", dtype=dt)
            rows = []
            for _ in range(ITERS):
                state, m = step(state)
                rows.append(m)
            sharded = torch.load(os.path.join(out, f"{name}_{dtype}",
                                              f"{name}.pt"),
                                 weights_only=False)
            singles[name, dtype] = (learner.state_to_dict(state), rows,
                                    sharded)
        yield want, ranks, singles
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("case,atol,rtol", [
    (("xla", "float64"), 1e-12, 1e-12),
    (("xla", "float32"), 1e-5, 1e-4),
    (("fused_update", "float32"), 2e-5, 2e-3)])
def test_sharded_unfused_step_matches_one_process(runs, case, atol, rtol):
    _, _, singles = runs
    one, rows, sharded = singles[case]
    two = sharded["state"]
    assert sharded["sharded"] and sharded["world"] == W
    assert two["iteration"] == one["iteration"] == ITERS
    assert two["adam"]["count"] == one["adam"]["count"]
    for a, b in ((two["params"], one["params"]),
                 (two["adam"]["mu"], one["adam"]["mu"]),
                 (two["adam"]["nu"], one["adam"]["nu"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=rtol)
    for k, v in one["env_state"].items():
        np.testing.assert_allclose(two["env_state"][k].double().numpy(),
                                   v.double().numpy(), atol=atol, rtol=rtol,
                                   err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(two["generators"],
                                                 one["generators"]))
    for mine, theirs in zip(sharded["metrics"], rows):
        for k in ("episodes", "goal_rate", "collision_rate",
                  "timeout_rate"):
            assert float(mine[k]) == float(theirs[k]), k
        for k, v in theirs.items():
            np.testing.assert_allclose(float(mine[k]), float(v), rtol=rtol,
                                       atol=atol, err_msg=k)


def test_sharded_fused_grads_match_jax_shard_map(runs):
    want, ranks, _ = runs
    sizes = [512, 64, 4096, 64, 64, 1] * 2 + [1]
    for got in ranks:
        g = got["grads"][0].numpy()
        i = 0
        for k, n in enumerate(sizes):
            a, b = g[i:i + n], want["grads"][i:i + n]
            assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) \
                < GRAD_REL_TOL, k
            i += n
        for k, v in want["aux"].items():
            np.testing.assert_allclose(float(got["aux"][k][0]), v,
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    assert torch.equal(ranks[0]["grads"], ranks[1]["grads"])


def _wrap_dist(a, b):
    d = np.abs(a - b) % 1.0
    return np.minimum(d, 1.0 - d)


def test_sharded_fused_rollout_matches_jax_shard_map(runs):
    want, ranks, _ = runs
    B = ROLL["n_envs"] // W
    wb = want["batch"]
    wrapped_all = []
    for r, got in enumerate(ranks):
        rows = slice(r * B, (r + 1) * B)
        tb = {k: v.numpy() for k, v in got["batch"].items()}
        jb = {k: v[:, rows] for k, v in wb.items()}
        np.testing.assert_array_equal(tb["dones"], jb["dones"])
        wrapped = np.zeros(B, bool)
        for t in range(ROLL["n_steps"]):
            to, jo = tb["obs"][t], jb["obs"][t]
            for f in ANGLE_FEATURES:
                np.testing.assert_allclose(
                    _wrap_dist(to[~wrapped, f], jo[~wrapped, f]), 0,
                    atol=ATOL)
                wrapped |= np.abs(to[:, f] - jo[:, f]) > 0.5
            keep = ~wrapped
            other = [f for f in range(8) if f not in ANGLE_FEATURES]
            np.testing.assert_allclose(
                to[keep][:, other], jo[keep][:, other], rtol=0,
                atol=ATOL * max(1.0, np.abs(jo).max()))
            for k in ("actions", "log_probs", "values"):
                np.testing.assert_allclose(
                    tb[k][t][keep], jb[k][t][keep], rtol=0,
                    atol=ATOL * max(1.0, np.abs(jb[k][t]).max()), err_msg=k)
            np.testing.assert_allclose(tb["rewards"][t][keep],
                                       jb["rewards"][t][keep], rtol=0,
                                       atol=REWARD_ATOL)
        wrapped_all.append(wrapped)
        px = got["px"].numpy()
        np.testing.assert_allclose(px[keep], want["px"][rows][keep], rtol=0,
                                   atol=ATOL * np.abs(want["px"]).max())
    assert np.concatenate(wrapped_all).mean() <= MAX_WRAPPED
    assert want["metrics"]["episodes"] > 0, "the shape should end episodes"
    for got in ranks:
        m = {k: float(v) for k, v in got["metrics"].items()}
        for k in ("episodes", "goal_rate", "collision_rate", "timeout_rate"):
            assert m[k] == want["metrics"][k], k
        for k in ("ep_return_mean", "ep_length_mean"):
            np.testing.assert_allclose(m[k], want["metrics"][k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_fused_update_refuses_rows_that_are_not_128s():
    """(minibatch / W) % 128 != 0 is refused with JAX's message; the same
    config passes with twice the rows."""
    two = mesh_lib.Mesh(0, W, object(), torch.device("cpu"))
    cfg = PPOConfig(n_envs=16, n_steps=32, minibatch_size=128,
                    total_timesteps=16 * 32, fused_update=True)
    with pytest.raises(ValueError, match=r"minibatch_size / n_devices\) % 128"):
        learner.make_train_step(cfg, TP, "cpu", mesh=two)
    learner.make_train_step(dataclasses.replace(cfg, minibatch_size=256),
                            TP, "cpu", mesh=two)


if __name__ == "__main__":
    _worker(sys.argv[2])
