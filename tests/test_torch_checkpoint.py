"""The port's checkpoints and run logs (`learner.state_to_dict` /
`state_from_dict`, `utils/checkpoint.py`, `utils/logging.py`) on the CPU
at tiny shapes.

A `TrainState` and a `PopulationState` survive a save and restore whole:
params, Adam state, every env field, obs, iteration and each generator's
state (the next draws agree).  The manager keeps the newest 5 steps, moves
best/ only on a strictly better finite value that a new manager still
knows, refuses a checkpoint whose shapes differ from the run's, and keeps
the previous checkpoint whole when a save dies half-way.  The port's
`MetricsLogger` writes the CSV and JSONL that the JAX package's writes for
the same rows, a widened header and a resumed append included."""

import csv
import dataclasses
import json

import pytest
import torch

from acas2d_tpu.utils.logging import MetricsLogger as JMetricsLogger
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import tpu_default
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils import checkpoint
from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
from acas2d_tpu_torch.utils.logging import MetricsLogger

CFG = tpu_default(n_envs=64, n_steps=32, minibatch_size=512)


def _solo(seed=0):
    st = learner.init_train_state(CFG, DEFAULT_PARAMS, "cpu", seed=seed)
    # a state a few steps into a run: moments, count, iteration, generator
    torch.randn(5, generator=st.generator)
    return st.replace(
        opt_state=learner.AdamState(mu=torch.randn_like(st.params),
                                    nu=torch.rand_like(st.params), count=7),
        iteration=3)


def _pop(pop=2):
    st = population.init_population(CFG, DEFAULT_PARAMS, pop, "cpu")
    for g in st.generators:
        torch.rand(3, generator=g)
    return st.replace(iteration=2)


def _assert_same(a, b):
    assert type(a) is type(b)
    assert torch.equal(a.params, b.params)
    assert torch.equal(a.opt_state.mu, b.opt_state.mu)
    assert torch.equal(a.opt_state.nu, b.opt_state.nu)
    assert a.opt_state.count == b.opt_state.count
    for f in dataclasses.fields(EnvState):
        x, y = getattr(a.env_state, f.name), getattr(b.env_state, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name
    assert torch.equal(a.obs, b.obs)
    assert a.iteration == b.iteration
    assert len(a.generators) == len(b.generators)
    for ga, gb in zip(a.generators, b.generators):
        assert ga is not gb
        assert torch.equal(torch.rand(4, generator=ga),
                           torch.rand(4, generator=gb))


@pytest.mark.parametrize("make", [_solo, _pop], ids=["solo", "population"])
def test_round_trip_keeps_the_whole_state(make, tmp_path):
    state = make()
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(4096, learner.state_to_dict(state))
    assert mgr.latest_step() == 4096
    if make is _pop:          # a fresh state of the run's kind and shapes
        target = population.init_population(
            dataclasses.replace(CFG, seed=9), DEFAULT_PARAMS, 2, "cpu")
    else:
        target = learner.init_train_state(CFG, DEFAULT_PARAMS, "cpu", seed=5)
    _assert_same(learner.state_from_dict(mgr.restore(), target), state)
    raw = mgr.restore_raw()
    assert set(raw) == {"params", "iteration"}
    assert raw["iteration"] == state.iteration
    assert torch.equal(raw["params"], state.params)


def test_checkpoint_is_plain_tensors_ints_and_strings(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, learner.state_to_dict(_pop()))
    raw = torch.load(tmp_path / "1" / "state.pt", weights_only=True)
    assert raw["kind"] == "population"
    assert raw["shapes"] == {"population": 2, "n_envs": 64, "obs_dim": 8,
                             "n_params": raw["params"].shape[-1],
                             "max_traffic": 1}
    assert len(raw["generators"]) == 2


def test_keeps_the_newest_five_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = learner.state_to_dict(_solo())
    for step in range(1, 8):
        mgr.save(step * 2048, state)
    assert mgr.steps() == [s * 2048 for s in range(3, 8)]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        str(s * 2048) for s in range(3, 8))
    with pytest.raises(FileNotFoundError):
        mgr.restore_raw(step=2048)


def test_best_moves_only_on_a_strictly_better_value(tmp_path):
    directory = str(tmp_path / "checkpoints")
    mgr = CheckpointManager(directory)
    a, b, c = (learner.state_to_dict(_solo(i)) for i in range(3))
    assert mgr.update_best(100, a, {"eval_return_mean": 10.0})
    assert not mgr.update_best(200, b, {"eval_return_mean": 10.0})
    assert not mgr.update_best(300, b, {"eval_return_mean": float("nan")})
    assert not mgr.update_best(300, b, {"eval_return_std": 99.0})
    assert torch.equal(mgr.restore_raw(best=True)["params"], a["params"])
    with open(tmp_path / "checkpoints" / "best" / "best_value.json") as f:
        assert json.load(f) == {"value": 10.0, "step": 100}
    # a new manager (a resumed process) keeps the persisted best
    mgr2 = CheckpointManager(directory)
    assert mgr2.best_value == 10.0
    assert not mgr2.update_best(400, b, {"eval_return_mean": 9.5})
    assert mgr2.update_best(500, c, {"eval_return_mean": 10.5})
    assert torch.equal(mgr2.restore_raw(best=True)["params"], c["params"])
    with open(tmp_path / "checkpoints" / "best" / "best_value.json") as f:
        assert json.load(f) == {"value": 10.5, "step": 500}


@pytest.mark.parametrize("target", ["n_envs", "population", "kind"])
def test_restore_refuses_other_shapes(target, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2048, learner.state_to_dict(_pop(2)))
    if target == "n_envs":
        cfg = dataclasses.replace(CFG, n_envs=32)
        like = population.init_population(cfg, DEFAULT_PARAMS, 2, "cpu")
        match = "n_envs 64 vs 32"
    elif target == "population":
        like = _pop(3)
        match = "population 2 vs 3"
    else:
        like = _solo()
        match = "population state"
    with pytest.raises(ValueError, match=match):
        learner.state_from_dict(mgr.restore(), like)


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore()


def test_a_save_killed_half_way_keeps_the_last_checkpoint(tmp_path,
                                                           monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    first = _solo(0)
    mgr.save(2048, learner.state_to_dict(first))
    real = torch.save

    def dies(obj, path):
        real(obj, path)
        with open(path, "r+b") as f:       # a torn write
            f.truncate(100)
        raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint.torch, "save", dies)
    second = learner.state_to_dict(_solo(1))
    with pytest.raises(KeyboardInterrupt):
        mgr.save(4096, second)
    with pytest.raises(KeyboardInterrupt):
        mgr.update_best(4096, second, {"eval_return_mean": 1.0})
    monkeypatch.setattr(checkpoint.torch, "save", real)
    assert mgr.latest_step() == 2048
    _assert_same(learner.state_from_dict(mgr.restore(), _solo(3)), first)
    assert not (tmp_path / "best" / "state.pt").exists()
    assert mgr.best_value is None


# -------------------------------------------------------------- logging

ROWS = [{"loss": 1.5, "iteration": 1, "steps_per_s": 2.5e6},
        {"loss": 1.25, "iteration": 2, "steps_per_s": 2.6e6,
         "eval_return_mean": 31.0},          # widens the header
        {"loss": 1.0, "iteration": 3, "steps_per_s": 2.7e6}]
RESUMED = [{"loss": 0.75, "iteration": 4, "steps_per_s": 2.8e6,
            "explained_variance": 0.5},      # widens a file it did not write
           {"loss": 0.5, "iteration": 5, "steps_per_s": 2.9e6}]


def _write(make, out_dir):
    for rows in (ROWS, RESUMED):            # a second logger resumes
        lg = make(str(out_dir), "train")
        for r in rows:
            lg.log(dict(r), step=2048 * r["iteration"])
        lg.close()


def _read(out_dir):
    with open(out_dir / "train.csv", newline="") as f:
        reader = csv.DictReader(f)
        header = reader.fieldnames
        table = [{k: v for k, v in row.items() if k != "wall_time_s"}
                 for row in reader]
    with open(out_dir / "train.jsonl") as f:
        lines = [json.loads(line) for line in f]
    for line in lines:
        assert isinstance(line.pop("wall_time_s"), float)
    return header, table, lines


def test_logger_writes_what_the_jax_logger_writes(tmp_path):
    _write(MetricsLogger, tmp_path / "port")
    _write(lambda d, name: JMetricsLogger(d, name, tensorboard=False,
                                          echo=False), tmp_path / "jax")
    port, jax = _read(tmp_path / "port"), _read(tmp_path / "jax")
    assert port == jax
    header, table, lines = port
    assert header == ["loss", "iteration", "steps_per_s", "wall_time_s",
                      "global_step", "eval_return_mean",
                      "explained_variance"]
    assert len(table) == len(lines) == 5
    assert table[0]["eval_return_mean"] == ""       # old rows, empty cells
    assert [r["global_step"] for r in lines] == [2048 * i
                                                for i in range(1, 6)]
    assert not (tmp_path / "port" / "train.csv.tmp").exists()
