"""K PPO iterations a call (`--iters-per-call`, `learner.make_train_loop`,
`population.make_population_loop`) on the CPU.

* A K-call equals K eager steps bit for bit: params, Adam moments and
  count, env state, obs, every metric and the generators; solo, P = 2 and
  the bf16 update.  On the CPU the loop is those steps; the card's loop
  (`learner.ReplayedLoop`) is held here too, with an eager stand-in for
  the CUDA graph (its replay reruns the captured iteration), which checks
  its bookkeeping: the draws made ahead in the eager order, the static
  inputs, the state handed between calls, the counts.  The graph itself
  is checked on the card (tests/test_torch_cuda.py, chip_smoke.py).
* `resolve_iters_per_call` answers as JAX `train.resolve_iters_per_call`
  (the port's CUDA device for JAX's accelerator backend).
* `train.py` logs K rows a call, overshoots a budget as JAX's loop does,
  and a run stopped by a Ctrl-C in the middle of a call resumes exactly.
* One K = 2 call against JAX's `make_train_loop(..., 2)` at the shape and
  tolerances of tests/test_torch_slice.py, with the draws JAX derives from
  its key in each iteration.
"""

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import train as jtrain
from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.ppo import learner as jlearner
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
from acas2d_tpu.ppo.config import tpu_default as jtpu_default
from acas2d_tpu_torch import train
from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig, tpu_default
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils import profiling
from acas2d_tpu_torch.utils.params_io import from_jax_params

TINY = dict(n_envs=64, n_steps=16, fused_chunk=8, minibatch_size=256,
            n_epochs=2, total_timesteps=64 * 16 * 8, fused_rollout=True,
            fused_update=True, anneal_lr=True)
B = 64 * 32
TRAIN_ARGV = ["--preset", "tpu", "--fused-rollout", "--fused-update",
              "--device", "cpu", "--n-envs", "64",
              "--n-steps", "32", "--minibatch-size", "512", "--n-epochs",
              "2", "--eval-episodes", "2", "--checkpoint-every", str(B),
              "--run-name", "r", "--iters-per-call", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(kind):
    if kind == "ref":
        # the reference preset (one env, minibatch 64 cut to 16, the
        # unfused rollout and the autograd update) at 32 steps
        cfg = PPOConfig(n_steps=32, minibatch_size=16, n_epochs=2)
        return (cfg, lambda: learner.init_train_state(cfg, TP, "cpu"),
                learner.make_train_step(cfg, TP, "cpu"),
                learner._solo_iteration(cfg, TP, torch.device("cpu")))
    cfg = PPOConfig(**TINY, fused_update_bf16=kind == "bf16")
    if kind == "p2":
        return (cfg, lambda: population.init_population(cfg, TP, 2, "cpu"),
                population.make_population_step(cfg, TP, "cpu"),
                population._population_iteration(cfg, TP))
    return (cfg, lambda: learner.init_train_state(cfg, TP, "cpu"),
            learner.make_train_step(cfg, TP, "cpu"),
            learner._solo_iteration(cfg, TP, torch.device("cpu")))


def _assert_same(a, b, eager_rows, calls):
    assert a.iteration == b.iteration
    assert a.opt_state.count == b.opt_state.count
    for x, y in zip(learner._state_leaves(a), learner._state_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for g, h in zip(a.generators, b.generators):
        assert torch.equal(g.get_state(), h.get_state())
    for k in eager_rows[0]:
        assert torch.equal(torch.stack([r[k] for r in eager_rows]),
                           torch.cat([c[k] for c in calls])), k


def _eager(step, state, n):
    rows = []
    for _ in range(n):
        state, m = step(state)
        rows.append(m)
    return state, rows


@pytest.mark.parametrize("kind", ["solo", "p2", "bf16", "ref"])
def test_a_call_equals_k_eager_steps(kind):
    cfg, init, step, _ = _case(kind)
    a, rows = _eager(step, init(), 6)
    loop = (population.make_population_loop(cfg, TP, 3, "cpu")
            if kind == "p2" else learner.make_train_loop(cfg, TP, 3, "cpu"))
    b, calls = init(), []
    for _ in range(2):
        b, m = loop(b)
        assert all(v.shape[0] == 3 for v in m.values())
        calls.append(m)
    _assert_same(a, b, rows, calls)


class _EagerGraph:
    """Stands in for torch.cuda.CUDAGraph: replay() reruns the captured
    iteration on the static tensors, and, as a graph's replay runs no host
    code, leaves the program's tally and counters as they were."""
    owner = None

    def replay(self):
        rec = profiling.RECORDER
        kept, counted = dict(profiling.TALLY), dict(rec._counters)
        self.owner.metrics.copy_(_real_captured(self.owner))
        profiling.TALLY.clear()
        profiling.TALLY.update(kept)
        rec._counters.clear()
        rec._counters.update(counted)


_real_captured = learner._IterationGraph.captured


@pytest.fixture
def eager_graphs(monkeypatch):
    """Lets `learner.ReplayedLoop` run on the CPU: streams that are no-ops
    and a graph whose capture runs the iteration once and whose replay
    reruns it."""
    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    def captured(self):
        self.graph.owner = self
        return _real_captured(self)

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _EagerGraph)
    monkeypatch.setattr(learner._IterationGraph, "captured", captured)


@pytest.mark.parametrize("kind", ["solo", "p2", "bf16", "ref"])
def test_the_replayed_loop_keeps_its_books(kind, eager_graphs):
    """The card's loop with an eager stand-in for its graph: two calls of
    K = 3 (the first builds the graph from its first iteration) equal six
    eager steps bit for bit, generators included, and leave the caller's
    state as it was."""
    cfg, init, step, iteration = _case(kind)
    a, rows = _eager(step, init(), 6)
    loop = learner.ReplayedLoop(iteration, cfg, 3)
    b0 = init()
    before = [t.clone() for t in learner._state_leaves(b0)]
    b, m1 = loop(b0)
    b, m2 = loop(b)
    _assert_same(a, b, rows, [m1, m2])
    assert len(loop._graphs) == 1 and b0.iteration == 0
    assert all(torch.equal(x, y)
               for x, y in zip(before, learner._state_leaves(b0)))


def test_a_replay_tallies_what_its_capture_held(eager_graphs):
    """The unfused path's env and minibatch steps: the capture's own
    tally is put back, and each replay adds the iteration's (32 env steps,
    2 x 2 autograd steps) to TALLY and, while a profiler records, to the
    counters."""
    cfg, init, _, iteration = _case("ref")
    keys = ("rollout.env_steps", "update.autograd_steps")
    due = {"rollout.env_steps": 32, "update.autograd_steps": 4}
    loop = learner.ReplayedLoop(iteration, cfg, 3)
    before = {k: profiling.TALLY.get(k, 0) for k in keys}
    b, _ = loop(init())
    graph, = loop._graphs.values()
    assert graph.tallied == due
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.clear()
        b, _ = loop(b)
        counted = profiling.counters()
    profiling.clear()
    for k in keys:
        assert profiling.TALLY[k] - before[k] == 6 * due[k]
        assert counted[k] == 3 * due[k]


@pytest.mark.parametrize("requested", [None, 0, 1, 4, 32])
@pytest.mark.parametrize("preset,backend", [("tpu", "tpu"), ("tpu", "cpu"),
                                            ("reference", "tpu")])
@pytest.mark.parametrize("n_envs", [2048, 1024, 64])
def test_resolve_iters_per_call_matches_jax(requested, preset, backend,
                                            n_envs):
    jcfg = dataclasses.replace(
        jtpu_default() if preset == "tpu" else JPPOConfig(), n_envs=n_envs)
    cfg = dataclasses.replace(
        tpu_default() if preset == "tpu" else PPOConfig(), n_envs=n_envs)
    device = torch.device("cuda" if backend != "cpu" else "cpu")
    assert (train.resolve_iters_per_call(requested, preset, device, cfg)
            == jtrain.resolve_iters_per_call(requested, preset, backend,
                                             jcfg))


def _run(argv, out, total, resume=False):
    return train.run(train.parse_args(
        argv + ["--total-steps", str(total), "--out-dir", str(out)]
        + (["--resume"] if resume else [])))


def _log(run_dir):
    with open(os.path.join(run_dir, "train.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("steps_per_s", "seconds", "wall_time_s")}
                for line in f]


def test_train_logs_k_rows_a_call_and_overshoots(tmp_path, capsys):
    """K = 2 and a budget of 3 batches: two calls, four rows (the second
    call runs whole, as JAX's loop does); a call's rows share its time;
    the first eval fires after the first call and checkpoints fall
    between calls."""
    rows = _run(TRAIN_ARGV + ["--eval-every", str(2 * B)], tmp_path, 3 * B)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["iteration"] for r in rows] == [1, 2, 3, 4]
    assert [r["global_step"] for r in rows] == [B, 2 * B, 3 * B, 4 * B]
    assert [("eval_return_mean" in r) for r in rows] == [False, True,
                                                         False, True]
    for r, s in zip(rows[::2], rows[1::2]):
        assert r["seconds"] == s["seconds"]
        assert r["steps_per_s"] == pytest.approx(B / r["seconds"])
    with open(tmp_path / "r" / "summary.json") as f:
        summary = json.load(f)
    assert summary["iters_per_call"] == 2
    assert summary["global_step"] == 4 * B
    assert summary["phases"]["dispatch_calls"] == 2
    steps = sorted(int(d) for d in os.listdir(tmp_path / "r" / "checkpoints")
                   if d.isdigit())
    assert steps == [2 * B, 4 * B]


def test_a_ctrl_c_in_the_middle_of_a_call_resumes_exactly(
        tmp_path, monkeypatch, capsys):
    """K = 2: a Ctrl-C inside the second call, after its first iteration
    and its draws, keeps the first call's state with the generators
    rewound, and --resume continues to the straight run's bits."""
    argv = TRAIN_ARGV + ["--anneal-lr", "--eval-every", str(64 * B)]
    _run(argv, tmp_path / "straight", 6 * B)
    real = learner.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def interrupted(state, *a, **k):
            out = step(state, *a, **k)
            if out[0].iteration == 3:
                raise KeyboardInterrupt
            return out
        return interrupted

    monkeypatch.setattr(learner, "make_train_step", make)
    rows = _run(argv, tmp_path / "split", 6 * B)
    assert [r["iteration"] for r in rows] == [1, 2]
    assert "interrupted; saving checkpoint" in capsys.readouterr().err
    monkeypatch.setattr(learner, "make_train_step", real)
    rows = _run(argv, tmp_path / "split", 6 * B, resume=True)
    assert [r["iteration"] for r in rows] == [3, 4, 5, 6]
    straight, split = tmp_path / "straight" / "r", tmp_path / "split" / "r"
    a = torch.load(straight / "checkpoints" / str(6 * B) / "state.pt",
                   weights_only=True)
    b = torch.load(split / "checkpoints" / str(6 * B) / "state.pt",
                   weights_only=True)
    assert a["iteration"] == b["iteration"] == 6
    assert a["adam"]["count"] == b["adam"]["count"]
    for k in ("params", "obs"):
        assert torch.equal(a[k], b[k]), k
    for k in ("mu", "nu"):
        assert torch.equal(a["adam"][k], b["adam"][k]), k
    for k, v in a["env_state"].items():
        assert torch.equal(v, b["env_state"][k]), k
    assert all(torch.equal(x, y)
               for x, y in zip(a["generators"], b["generators"]))
    assert _log(split) == _log(straight)


# ------------------------------------------- one K = 2 call against JAX

SLICE = dict(n_envs=2048, n_steps=16, fused_rollout=True, fused_chunk=8,
             minibatch_size=4096, n_epochs=2, total_timesteps=2048 * 16)
PARAM_ATOL = 2e-6          # tests/test_torch_slice.py's


def _flat_of(jtree):
    m = ActorCritic()
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jtree)))
    return flatten(m)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def k2_calls():
    """JAX's make_train_loop(..., 2) and the port's K = 2 loop from the
    same start, the port given the draws JAX derives in each iteration
    (learner.py:170-172, 501, 460: the rollout splits the key for its
    seed, the update splits the rest for its epochs)."""
    jcfg, cfg = JPPOConfig(**SLICE), PPOConfig(**SLICE, fused_update=True)
    model = JActorCritic()
    js = jlearner.init_train_state(jax.random.PRNGKey(5), model, jcfg, JP)
    mid = np.random.default_rng(0).integers(1, JP.max_steps + 1, jcfg.n_envs)
    js = js.replace(env_state=js.env_state.replace(
        steps=jnp.asarray(mid, jnp.int32)))
    jnew, jm = jax.jit(jlearner.make_train_loop(model, jcfg, JP, 2))(js)

    draws, key = [], js.key
    for _ in range(2):
        key, k_seed = jax.random.split(key)
        seed = int(jax.random.randint(k_seed, (), 0,
                                      jnp.iinfo(jnp.int32).max, jnp.int32))
        key, k_update = jax.random.split(key)
        draws.append((seed, [np.asarray(jax.random.permutation(
            k, cfg.batch_size // cfg.shuffle_block))
            for k in jax.random.split(k_update, cfg.n_epochs)]))
    np.testing.assert_array_equal(np.asarray(key), np.asarray(jnew.key))

    es = js.env_state
    env_state = EnvState(**{f: _t(getattr(es, f)) for f in (
        "px", "py", "ppsi", "pa_lat", "tx", "ty", "tv", "tpsi",
        "num_traffic", "steps", "total_reward", "outcome")})
    params = _flat_of(js.params)
    state = learner.TrainState(
        params=params, opt_state=learner.Optimizer(cfg).init(params),
        env_state=env_state, obs=_t(js.obs), generator=torch.Generator())
    step = learner.make_train_step(cfg, TP, device="cpu")
    pending = iter(draws)
    new, m = learner.stacked_loop(
        lambda s: step(s, *next(pending)), 2)(state)
    return jnew, jm, new, m


def test_k2_call_metrics_match_jax(k2_calls):
    jnew, jm, new, m = k2_calls
    assert np.asarray(jm["episodes"]).shape == (2,)
    assert (np.asarray(jm["episodes"]) > 0).all()
    for k in ("episodes", "goal_rate", "collision_rate", "timeout_rate"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)
    for k in ("ep_return_mean", "ep_length_mean"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("policy_loss", "value_loss", "entropy", "approx_kl",
              "clip_fraction", "loss", "explained_variance"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert new.iteration == int(jnew.iteration) == 2


def test_k2_call_params_and_env_state_match_jax(k2_calls):
    jnew, jm, new, m = k2_calls
    np.testing.assert_allclose(new.params.numpy(),
                               _flat_of(jnew.params).numpy(), rtol=0,
                               atol=PARAM_ATOL)
    assert new.opt_state.count == 2 * 2 * 8
    np.testing.assert_array_equal(new.env_state.steps.numpy(),
                                  np.asarray(jnew.env_state.steps))
