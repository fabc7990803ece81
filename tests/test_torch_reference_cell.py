"""The `reference` configuration (`PPOConfig()`: the upstream's published
run, one env, 2048 steps, minibatch 64, the unfused rollout and the
autograd update) and its benchmark cell `reference.train`
(`benchmark/drive_unfused.py`), on the CPU at a tiny size, one torch
thread.

* The program's unfused step (1 env, 64 steps, minibatch 16, 2 epochs, 3
  iterations) against the cell's plain reference
  (`benchmark/reference/unfused.py`) on seeded random weights, from a
  fresh spawn and from an episode that times out inside the first
  rollout (so that a respawn is followed too): the losses, Adam's first
  moment and the params.
* The program's tallies of the unfused path (`utils.profiling.TALLY`,
  the counters while a profiler records): n_steps env steps and n_epochs
  x n_minibatches autograd steps an iteration, eager; none on the fused
  paths.  Replayed on the card: `test_a_replayed_call_tallies_its_steps`
  (marked `cuda`; `python -m pytest --noconftest
  tests/test_torch_reference_cell.py -q` there); on the CPU with an eager
  stand-in for the graph, `tests/test_torch_iters_per_call.py`.
* Both new cells load (`spec.load_cell`), and one traced run of
  `reference.train` at the tiny size with its controls: `correct`,
  `launch_gap` 0, the faults fail its limits; with a program that keeps
  no tallies (the parent of the counters) the run holds the launch
  counters alone.  The three readers of the unfused path on a
  synthetic trace.
"""

import math
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from acas2d_tpu_torch.config import DEFAULT_PARAMS as TP  # noqa: E402
from acas2d_tpu_torch.envs import core  # noqa: E402
from acas2d_tpu_torch.ppo import learner  # noqa: E402
from acas2d_tpu_torch.ppo.config import PPOConfig  # noqa: E402
from acas2d_tpu_torch.utils import profiling  # noqa: E402
from benchmark import run, spec, tracing  # noqa: E402
from benchmark.reference import ppo as ref  # noqa: E402
from benchmark.reference import unfused  # noqa: E402

TINY = dict(n_steps=64, minibatch_size=16, n_epochs=2)
STEPS = 2 * 64 // 16              # autograd steps an iteration
SEED = 2 ** 33 + 5                # past 32 signed bits, as a run's seed may be
ITERATIONS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tally():
    return {k: profiling.TALLY.get(k, 0)
            for k in ("rollout.env_steps", "update.autograd_steps")}


def _start(steps: int):
    """The program's and the reference's state from one set of inputs:
    random weights, a spawn from uniforms whose step counter is set to
    `steps`, and a generator each, seeded alike."""
    gen = torch.Generator().manual_seed(11)
    params = 0.3 * torch.randn(1, ref.N_PARAMS, generator=gen)
    u = torch.rand(1, 5, generator=gen, dtype=torch.float64)
    es, obs = core.observe(core.spawn_from_uniforms(u, TP, torch.float32), TP)
    es = es.replace(steps=torch.full_like(es.steps, steps))
    cfg = PPOConfig(**TINY)
    prog = learner.TrainState(
        params=params[0].clone(), opt_state=learner.Optimizer(cfg).init(
            params[0]), env_state=es, obs=obs,
        generator=torch.Generator().manual_seed(5))
    tr = unfused.start(params, u, [torch.Generator().manual_seed(5)])
    tr.env.steps = torch.full_like(tr.env.steps, steps)
    return cfg, prog, tr


@pytest.mark.parametrize("steps", [1, 990], ids=["fresh", "timeout"])
def test_the_unfused_step_follows_its_plain_reference(steps):
    cfg, state, tr = _start(steps)
    rcfg = ref.Config(n_envs=1, n_steps=64, minibatch=16, n_epochs=2)
    step = learner.make_train_step(cfg, TP, "cpu")
    episodes = 0.0
    for i in range(ITERATIONS):
        state, m = step(state)
        want = unfused.iteration(rcfg, tr)["loss"]
        episodes += float(m["episodes"])
        # the mean loss over the iteration's 8 steps: the program
        # normalises each epoch's minibatches in one pass, the reference
        # each step's; both round alike on the CPU, allow float32's
        # rounding of a mean of 8
        assert math.isclose(float(m["loss"]), float(want[0]),
                            rel_tol=8 * 2 ** -23), i
        if i == 0:
            # Adam's first moment after 8 steps: each leaf to float32's
            # rounding of its own scale
            scale = tr.mu.abs().max()
            assert (state.opt_state.mu - tr.mu[0]).abs().max() \
                <= 8 * 2 ** -23 * scale
    # the params after 24 Adam steps: a few float32 ulps of each entry's
    # step size (3e-4)
    assert (state.params - tr.params[0]).abs().max() <= 1e-9
    # the env: a few float32 ulps of a position in the 1600 px airspace
    assert (state.env_state.px - tr.env.px).abs().max() <= 1e-3
    assert (state.env_state.py - tr.env.py).abs().max() <= 1e-3
    assert (episodes > 0) == (steps > 1)


def test_an_eager_iteration_tallies_its_steps():
    cfg, state, _ = _start(1)
    before = _tally()
    loop = learner.make_train_loop(cfg, TP, 2, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.clear()
        state, _ = loop(state)
        counted = profiling.counters()
    profiling.clear()
    after = _tally()
    assert after["rollout.env_steps"] - before["rollout.env_steps"] == 2 * 64
    assert after["update.autograd_steps"] \
        - before["update.autograd_steps"] == 2 * STEPS
    assert counted["rollout.env_steps"] == 2 * 64
    assert counted["update.autograd_steps"] == 2 * STEPS


def test_the_fused_paths_tally_nothing():
    cfg = PPOConfig(n_envs=64, n_steps=16, minibatch_size=256, n_epochs=2,
                    fused_rollout=True, fused_update=True)
    state = learner.init_train_state(cfg, TP, "cpu")
    before = _tally()
    learner.make_train_step(cfg, TP, "cpu")(state)
    assert _tally() == before


@pytest.fixture(scope="module")
def cell_run():
    """One traced run of `reference.train` at the tiny size, K = 4, with
    its controls: (cell, record, result, the counters over the slice)."""
    cell = spec.load_cell("reference.train")
    cell.config.update(n_steps=64, minibatch_size=16, n_epochs=2)
    cell.traffic["warm_seconds"] = 0.0
    profiling.clear()
    try:
        rec = run.measure(cell, SEED, 0.3, True, torch.device("cpu"),
                          time.perf_counter(), True)
        out = run.result(cell, rec, True, {})
        counters = profiling.counters()
    finally:
        profiling.clear()
    return cell, rec, out, counters


def test_both_cells_load():
    att = spec.load_cell("solo_tpu.attempt")
    assert (att.config_name, att.traffic_name) == ("solo_tpu", "attempt")
    assert att.traffic["evals"] and att.limits["eval_gap"] == 1e-3
    assert {m["name"] for m in att.per_layer} >= {
        "greedy_eval.ms", "greedy_eval.device_ms", "greedy_eval.host_ms",
        "greedy_eval.chunks", "ppo_grads.roofline_pct"}
    cell = spec.load_cell("reference.train")
    conf = cell.config
    assert (conf["n_envs"], conf["n_steps"], conf["minibatch_size"],
            conf["n_epochs"], conf["iters_per_call"]) == (1, 2048, 64, 10, 4)
    assert not (conf["fused_rollout"] or conf["fused_update"])
    assert cell.traffic["drive"] == "unfused"
    assert [m["name"] for m in cell.end_to_end] == [
        "train_env_steps_per_s", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert names == {"unfused_rollout.step_us",
                     "unfused_rollout.kernels_per_step",
                     "autograd_update.step_us", "iteration.rollout_ms",
                     "iteration.gae_ms", "iteration.update_ms",
                     "device.idle_pct.train", "train_step.mfu_pct"}
    # the program's default preset is the configuration's PPO
    default = PPOConfig()
    for k in ("n_envs", "n_steps", "minibatch_size", "n_epochs", "gamma",
              "gae_lambda", "clip_range", "max_grad_norm", "learning_rate",
              "total_timesteps", "eval_every_steps"):
        assert conf[k] == getattr(default, k), k
    assert default.shuffle_block == 1


def test_the_cell_runs_correct_and_counts_exactly(cell_run):
    cell, rec, out, counters = cell_run
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(cell.limits)
    assert rec["numbers"]["launch_gap"] == 0.0
    assert rec["call_vs_steps"] == 0.0
    assert rec["work"]["iterations"] % 4 == 0
    tr = rec["trace"]
    assert tr.work["iterations"] == 1
    # the slice's one-iteration call, counted while the profiler records
    assert counters["rollout.env_steps"] == 64
    assert counters["update.autograd_steps"] == STEPS
    # no device marks on the CPU: the device readers find nothing to read
    assert "unfused_rollout.step_us" not in out["metrics"]
    assert rec["trace_file"]["bytes"] > 0


@pytest.mark.parametrize("fault", ["half", "reward", "tf32"])
def test_a_planted_fault_fails_the_limits(cell_run, fault):
    """The reference with half of each minibatch, or every reward + 1,
    fails a limit; on the CPU the TF32 control computes in float32 and
    passes."""
    cell, rec = cell_run[:2]
    nums = rec["controls"][fault]
    over = [k for k, lim in cell.limits.items()
            if k != "launch_gap" and not nums[k] <= lim]
    assert bool(over) == (fault != "tf32"), nums


def test_a_program_without_tallies_is_held_to_its_launches(monkeypatch):
    """The driver on a program that keeps no tallies, as the commit before
    them: the run is correct, the launch counters alone held."""
    cell = spec.load_cell("reference.train")
    cell.config.update(n_steps=16, minibatch_size=16, n_epochs=1)
    cell.traffic["warm_seconds"] = 0.0
    monkeypatch.delattr(profiling, "TALLY")
    monkeypatch.setattr(profiling, "tally", lambda *args: None)
    driver = spec.driver("unfused")
    assert driver._tally() is None
    rec = run.measure(cell, SEED, 0.1, False, torch.device("cpu"),
                      time.perf_counter())
    assert rec["numbers"]["launch_gap"] == 0.0
    assert run.result(cell, rec, False, {})["correct"] is True


def _ev(name, start, dur=1.0):
    return tracing.Event(name, start, dur)


def test_the_unfused_readers_on_a_synthetic_trace(monkeypatch):
    """Two iterations of 4 env steps and 2 minibatch steps: a rollout of
    10 us with 12 ops (marks left out), an update of 6 us."""
    dev = []
    for base in (0.0, 100.0):
        dev += [_ev("phase_mark_start(x)", base),
                *[_ev("add", base + 0.5 + i * 0.5, 0.2) for i in range(12)],
                _ev("phase_mark_rollout(x)", base + 10.0),
                _ev("gae", base + 11.0),
                _ev("phase_mark_gae(x)", base + 20.0),
                _ev("mm", base + 21.0),
                _ev("phase_mark_update(x)", base + 26.0)]
    tr = tracing.Trace(0.0, 200.0, dev, [], {"iterations": 2})
    monkeypatch.setattr(profiling, "counters", lambda: {
        "rollout.env_steps": 8, "update.autograd_steps": 4})
    record = {"trace": tr}
    read = {n: spec.reader(n).read(record) for n in (
        "unfused_rollout.step_us", "unfused_rollout.kernels_per_step",
        "autograd_update.step_us")}
    assert read == {"unfused_rollout.step_us": 2.5,
                    "unfused_rollout.kernels_per_step": 3.0,
                    "autograd_update.step_us": 3.0}
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert all(spec.reader(n).read(record) is None for n in read)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_replayed_call_tallies_its_steps(cuda):
    """On the card, two calls of K = 3 (the first captures the iteration's
    graph from its eager first iteration) equal six eager steps bit for
    bit, and TALLY and the counters grow by six iterations' steps: the
    capture's own are put back, each replay adds its graph's."""
    cfg = PPOConfig(**TINY)
    eager = learner.init_train_state(cfg, TP, cuda)
    step = learner.make_train_step(cfg, TP, cuda)
    for _ in range(6):
        eager, _ = step(eager)
    state = learner.init_train_state(cfg, TP, cuda)
    loop = learner.make_train_loop(cfg, TP, 3, cuda)
    before = _tally()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        profiling.clear()
        for _ in range(2):
            state, _ = loop(state)
        torch.cuda.synchronize()
        counted = profiling.counters()
    profiling.clear()
    after = _tally()
    for k, n in (("rollout.env_steps", 64), ("update.autograd_steps",
                                             STEPS)):
        assert after[k] - before[k] == 6 * n
        assert counted[k] == 6 * n
    for x, y in zip(learner._state_leaves(eager),
                    learner._state_leaves(state)):
        assert torch.equal(x, y)
