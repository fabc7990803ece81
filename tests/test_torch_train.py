"""The port's training driver (`python -m acas2d_tpu_torch.train`) end to
end on the CPU at a tiny shape: 64 envs x 32 steps, minibatch 1024, 2
epochs, 2 iterations, through the plain versions of both kernels.

It prints one JSON line of metrics per iteration, every metric is finite,
the first iteration is evaluated (sampled spawns or the Mersenne stream),
`--fused-update-bf16` reaches the gradient kernel (solo and population),
the unfused rollout and the autograd update run beside the fused ones
(solo and population), and the default device is CUDA.  Population runs
are tested in test_torch_population.py."""

import json
import math
import time

import numpy as np
import pytest
import torch

from acas2d_tpu_torch import train
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.ppo import learner

ITERS = 2
TINY = ["--preset", "tpu", "--fused-rollout", "--fused-update",
        "--device", "cpu", "--n-envs", "64", "--n-steps", "32", "--minibatch-size", "1024", "--n-epochs", "2",
        "--total-steps", str(ITERS * 64 * 32), "--eval-episodes", "4"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("exact_eval", [False, True])
def test_driver_prints_one_finite_row_per_iteration(exact_eval, capsys,
                                                    tmp_path):
    argv = TINY + ["--out-dir", str(tmp_path)] + (
        ["--exact-eval"] if exact_eval else [])
    rows = train.run(train.parse_args(argv))
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows and len(rows) == ITERS
    assert [r["iteration"] for r in rows] == [1, 2]
    assert [r["global_step"] for r in rows] == [64 * 32, 2 * 64 * 32]
    for row in rows:
        bad = [k for k, v in row.items() if not math.isfinite(v)]
        assert not bad, bad
    assert rows[0]["eval_done_all"] == 1.0
    assert 0.0 <= rows[0]["eval_goal_rate"] <= 1.0


def test_iteration_seconds_include_the_metrics_read(tmp_path):
    """A row's `seconds` runs from the step's start to its metrics on the
    host (the read that waits for the step's queued work), and
    `steps_per_s` divides the iteration's env-steps by it."""
    args = train.parse_args(TINY + ["--out-dir", str(tmp_path)])
    cfg = train.build_config(args)
    r = train._Run(args, cfg, str(tmp_path / "r"))
    state = learner.init_train_state(cfg, DEFAULT_PARAMS, "cpu")

    def step(s):
        return s.replace(iteration=s.iteration + 1), {}

    def make_rows(metrics):
        time.sleep(0.05)                  # a slow metrics read
        return [{}]

    _, rows = r.loop(state, step, make_rows, 1000, lambda s, g: ({}, {}))
    assert len(rows) == ITERS
    for row in rows:
        assert row["seconds"] >= 0.05
        assert row["steps_per_s"] == 1000 / row["seconds"]


@pytest.mark.parametrize("flag", [["--population", "2",
                                   "--no-fused-rollout"],
                                  ["--population", "2", "--no-fused-update"],
                                  ["--no-fused-rollout"],
                                  ["--no-fused-update"]])
def test_driver_runs_the_unfused_paths(flag, tmp_path):
    """The step-by-step rollout with the fused update, and the fused rollout
    with the autograd update, solo and population: one iteration each,
    every metric finite."""
    extra = ["--total-steps", str(64 * 32), "--reval-episodes", "0",
             "--out-dir", str(tmp_path)]
    rows = train.run(train.parse_args(TINY + flag + extra))
    assert len(rows) == 1
    cfg = train.build_config(train.parse_args(TINY + flag))
    assert (cfg.fused_rollout, cfg.fused_update) == (
        "--no-fused-rollout" not in flag, "--no-fused-update" not in flag)
    bad = [k for k, v in rows[0].items()
           if not all(math.isfinite(x) for x in np.ravel(v))]
    assert not bad, bad


@pytest.mark.parametrize("population", [0, 2])
def test_driver_trains_with_bf16_update(population, tmp_path, monkeypatch):
    """--fused-update-bf16, solo and population: every gradient call gets
    bf16=True, and the rows are finite."""
    calls = []
    real = learner.ppo_minibatch_grads_members

    def spy(*args, **kw):
        calls.append(kw["bf16"])
        return real(*args, **kw)

    monkeypatch.setattr(learner, "ppo_minibatch_grads_members", spy)
    extra = ["--out-dir", str(tmp_path)] + (
        ["--population", str(population), "--reval-episodes", "0"]
        if population else [])
    rows = train.run(train.parse_args(TINY + ["--fused-update-bf16"] + extra))
    assert len(rows) == ITERS
    assert calls and all(calls) and len(calls) == ITERS * 2 * 2
    for row in rows:
        bad = [k for k, v in row.items()
               if not all(math.isfinite(x) for x in np.ravel(v))]
        assert not bad, bad


@pytest.mark.parametrize("population", [0, 2])
def test_driver_spends_a_budget_that_is_not_a_multiple_of_the_batch(
        population, tmp_path):
    """3000 steps at a 2048-step batch: two iterations, the last one past
    the budget, as JAX train.py's `while gstep < total_timesteps` loop; the
    learning-rate anneal is still sized by n_iterations (= 1, as JAX
    learner.py sizes optax's schedule), so the second iteration runs at
    its clamped lr 0."""
    extra = ["--out-dir", str(tmp_path)] + (
        ["--population", str(population), "--reval-episodes", "0"]
        if population else [])
    argv = ["--device", "cpu", "--preset", "tpu", "--fused-rollout",
            "--fused-update", "--n-envs", "64",
            "--n-steps", "32", "--minibatch-size", "512", "--total-steps",
            "3000", "--eval-episodes", "4", "--anneal-lr"] + extra
    rows = train.run(train.parse_args(argv))
    assert [r["iteration"] for r in rows] == [1, 2]
    assert rows[-1]["global_step"] == 4096
    cfg = train.build_config(train.parse_args(argv))
    opt = learner.Optimizer(cfg)
    assert cfg.n_iterations == 1
    assert opt.total_updates == cfg.n_epochs * cfg.n_minibatches
    assert opt.step_size(opt.total_updates) == 0.0
    assert opt.step_size(2 * opt.total_updates) == 0.0


@pytest.mark.parametrize("flag", [["--gpus", "2"]])
def test_driver_does_not_know_unported_modes(flag, capsys):
    with pytest.raises(SystemExit):
        train.parse_args(TINY + flag)
    assert "unrecognized arguments" in capsys.readouterr().err


def test_driver_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run(train.parse_args(["--preset", "tpu"]))
