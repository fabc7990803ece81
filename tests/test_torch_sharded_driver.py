"""The training driver and the bench's scaling sweep on two gloo ranks
(`python -m torch.distributed.run --nproc-per-node 2 -m
acas2d_tpu_torch.train ...`, here through `parallel.launch`).

One launch of two ranks (`python -m tests.test_torch_sharded_driver worker
DIR`) runs, one after the other: a solo run of the unfused pair in float64
(4 iterations, an eval and checkpoints), the same with two iterations a
call, the same stopped after 2 iterations and resumed to 4 (one process
also resumes its checkpoint of 2 iterations), and `bench --scaling`
(tests/test_torch_sharded_pipeline.py runs a population).  The tests
hold them against one process:

  * one run dir, written by rank 0, whose summary says `n_devices` 2;
  * the solo run equals one process's within 1e-12 (float64), and its evals
    (rank 0's, on the same params) within 1e-9;
  * K = 2 a call (eager steps under gloo) and the resumed run equal the
    straight run bit for bit;
  * a 2-rank checkpoint resumes in one process, and continues as the 2-rank
    run does, within 1e-12;
  * the scaling sweep prints a point for n = 1 and n = 2 with JAX's keys,
    and its summary."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from acas2d_tpu_torch import train
from acas2d_tpu_torch.parallel import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
B = 16 * 16
# one eval a run (its first iteration's), since evals are most of the time
SOLO = ["--preset", "tpu", "--device", "cpu", "--n-envs", "16", "--n-steps",
        "16", "--minibatch-size", "64", "--n-epochs", "2", "--dtype",
        "float64", "--eval-every", str(8 * B), "--eval-episodes", "1",
        "--checkpoint-every", str(B), "--run-name", "r"]
SCALING = ["--scaling", "--device", "cpu", "--envs-per-device", "8",
           "--bench-steps", "4", "--train-steps", "8"]


def _solo(out, total, *extra):
    return SOLO + ["--out-dir", out, "--total-steps", str(total)] + list(extra)


def _runs(d):
    """Every run of the worker: (name, argv)."""
    return [("a", _solo(f"{d}/a", 4 * B)),
            ("k2", _solo(f"{d}/k2", 4 * B, "--iters-per-call", "2")),
            ("half", _solo(f"{d}/c", 2 * B)),
            ("resume", _solo(f"{d}/c", 4 * B, "--resume"))]


def _worker(d: str) -> None:
    from acas2d_tpu_torch import bench

    torch.set_num_threads(1)
    for _, argv in _runs(d):
        train.main(argv)
    out = bench.run(bench.parse_args(SCALING))
    if out is not None:
        with open(os.path.join(d, "scaling.json"), "w") as f:
            json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # the ranks' (OMP_NUM_THREADS=1)
    try:
        d = str(tmp_path_factory.mktemp("sharded_driver"))
        res = launch.check_ranks(launch.run_ranks(
            ["-m", "tests.test_torch_sharded_driver", "worker", d], 2,
            JOIN_S, cwd=ROOT))
        one = str(tmp_path_factory.mktemp("one_process"))
        train.main(_solo(f"{one}/a", 4 * B))
        # the 2-rank run's checkpoint of its first 2 iterations, resumed
        shutil.copytree(f"{d}/c", f"{one}/h")
        for step in (3 * B, 4 * B):
            shutil.rmtree(f"{one}/h/r/checkpoints/{step}")
        train.main(_solo(f"{one}/h", 4 * B, "--resume"))
        yield d, one, res
    finally:
        torch.set_num_threads(n)


def _ckpt(run_dir, step=4 * B):
    return torch.load(os.path.join(run_dir, "checkpoints", str(step),
                                   "state.pt"), weights_only=True)


def _rows(run_dir, name):
    with open(os.path.join(run_dir, f"{name}.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    return [{k: v for k, v in r.items()
             if k not in ("seconds", "steps_per_s", "wall_time_s",
                          "eval_seconds")} for r in rows]


def _assert_close(a, b, tol):
    assert a["iteration"] == b["iteration"]
    assert a["adam"]["count"] == b["adam"]["count"]
    for x, y in ((a["params"], b["params"]), (a["adam"]["mu"],
                                              b["adam"]["mu"]),
                 (a["adam"]["nu"], b["adam"]["nu"]), (a["obs"], b["obs"])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=tol)
    for k, v in a["env_state"].items():
        np.testing.assert_allclose(v.double().numpy(),
                                   b["env_state"][k].double().numpy(),
                                   rtol=0, atol=tol, err_msg=k)
    assert all(torch.equal(g, h) for g, h in zip(a["generators"],
                                                 b["generators"]))


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, dict):
            _assert_equal(v, b[k])
        elif isinstance(v, list) and v and torch.is_tensor(v[0]):
            assert all(torch.equal(x, y) for x, y in zip(v, b[k])), k
        elif torch.is_tensor(v):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def test_two_ranks_write_one_run_dir(runs):
    d, _, res = runs
    assert sorted(os.listdir(f"{d}/a")) == ["r"]
    run = f"{d}/a/r"
    with open(f"{run}/summary.json") as f:
        summary = json.load(f)
    assert summary["n_devices"] == 2 and summary["global_step"] == 4 * B
    assert summary["config"]["n_envs"] == 16
    assert len(_rows(run, "train")) == 4 and len(_rows(run, "eval")) == 1
    assert os.path.exists(f"{run}/checkpoints/best/state.pt")
    # rank 0 alone prints the rows
    assert res[0].stdout.count('"iteration": 1,') >= 1
    assert '"iteration"' not in res[1].stdout


def test_two_rank_run_matches_one_process(runs):
    d, one, _ = runs
    _assert_close(_ckpt(f"{d}/a/r"), _ckpt(f"{one}/a/r"), 1e-12)
    for x, y in zip(_rows(f"{d}/a/r", "train"), _rows(f"{one}/a/r", "train")):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_allclose(x[k], y[k], rtol=1e-9, atol=1e-12,
                                       err_msg=k)
    for x, y in zip(_rows(f"{d}/a/r", "eval"), _rows(f"{one}/a/r", "eval")):
        for k in x:
            np.testing.assert_allclose(x[k], y[k], rtol=1e-9, err_msg=k)


def test_two_iterations_a_call_under_gloo_equal_one(runs):
    d, _, _ = runs
    _assert_equal(_ckpt(f"{d}/k2/r"), _ckpt(f"{d}/a/r"))
    assert _rows(f"{d}/k2/r", "train") == _rows(f"{d}/a/r", "train")


def test_two_rank_resume_is_bit_for_bit(runs):
    d, _, _ = runs
    _assert_equal(_ckpt(f"{d}/c/r"), _ckpt(f"{d}/a/r"))


def test_two_rank_checkpoint_resumes_in_one_process(runs):
    d, one, _ = runs
    half = _ckpt(f"{d}/c/r", 2 * B)
    assert half["shapes"]["n_envs"] == 16 and half["obs"].shape[0] == 16
    _assert_close(_ckpt(f"{one}/h/r"), _ckpt(f"{d}/a/r"), 1e-12)


def test_scaling_sweep_on_two_ranks(runs):
    d, _, res = runs
    points = [json.loads(x) for x in res[0].stdout.splitlines()
              if x.startswith('{"n_devices"')]
    assert [p["n_devices"] for p in points] == [1, 2]
    for p in points:
        assert p["platform"] == "cpu"
        assert p["rollout_steps_per_s"] > 0 and p["train_steps_per_s"] > 0
    assert "rollout_efficiency" in points[1]
    assert "train_efficiency" in points[1]
    with open(f"{d}/scaling.json") as f:
        summary = json.load(f)
    assert summary["n_devices_max"] == 2 and summary["target"] == 0.8
    assert summary["value"] > 0
    assert '"n_devices"' not in res[1].stdout


if __name__ == "__main__":
    _worker(sys.argv[2])
