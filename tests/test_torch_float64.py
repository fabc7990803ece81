"""`--dtype float64` training in the port's driver, on the CPU at a tiny
shape (64 envs x 16 steps, minibatch 512, 1 epoch).

* A float64 run keeps everything in float64: params, Adam moments, env
  state and obs in every checkpoint, the metrics, and its evals (the
  in-training eval and `--exact-eval` get the run's dtype, as JAX's driver
  passes `dtype` to them); `summary.json` records the dtype.
* Two iterations and a `--resume` to four equal four straight, bit for
  bit (checkpoint tensors, generators and the logged rows).
* float64 with a fused kernel is refused before anything runs, solo and
  population: both kernels compute in float32.
* The float64 run follows the float32 run of the same seed: the same
  start (the float32 policy and spawns, widened), and after two
  iterations params within 1e-4 (float32 rounding grown over 8 Adam
  steps of ~3e-4).
"""

import json
import os

import pytest
import torch

from acas2d_tpu_torch import train
from acas2d_tpu_torch.ppo import learner

B = 64 * 16
TINY = ["--preset", "tpu", "--device", "cpu", "--n-envs", "64",
        "--n-steps", "16", "--minibatch-size", "512", "--n-epochs", "1",
        "--eval-episodes", "2", "--eval-every", str(2 * B),
        "--checkpoint-every", str(B), "--run-name", "r"]
F64 = TINY + ["--dtype", "float64"]
EXACT = ["--exact-eval"]
TIMING = {"steps_per_s", "seconds", "eval_seconds", "wall_time_s"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(argv, out, total, *extra):
    return train.run(train.parse_args(argv + [
        "--total-steps", str(total), "--out-dir", str(out), *extra]))


def checkpoint(out, step):
    return torch.load(os.path.join(out, "r", "checkpoints", str(step),
                                   "state.pt"), weights_only=True)


def log(out):
    with open(os.path.join(out, "r", "train.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in TIMING} for line in f]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    out = tmp_path_factory.mktemp("f64")
    seen = []
    real = learner.make_exact_eval_fn

    def spy(cfg, env_params, dtype=torch.float32, *a, **kw):
        seen.append(dtype)
        return real(cfg, env_params, dtype, *a, **kw)

    learner.make_exact_eval_fn = spy
    try:
        rows = run(F64 + EXACT, out, 4 * B)
    finally:
        learner.make_exact_eval_fn = real
    return out, rows, seen


def test_a_float64_run_stays_float64(straight):
    out, rows, seen = straight
    assert len(rows) == 4 and seen == [torch.float64]
    ck = checkpoint(out, 4 * B)
    assert ck["params"].dtype == torch.float64
    assert ck["adam"]["mu"].dtype == ck["adam"]["nu"].dtype == torch.float64
    assert ck["obs"].dtype == torch.float64
    for k, v in ck["env_state"].items():
        assert v.dtype in (torch.float64, torch.int32), k
    assert ck["env_state"]["px"].dtype == torch.float64
    with open(os.path.join(out, "r", "summary.json")) as f:
        summary = json.load(f)
    assert summary["config"]["dtype"] == "float64"
    assert not summary["config"]["fused_rollout"]
    assert "eval_return_mean" in rows[1]


def test_a_float64_resume_is_exact(straight, tmp_path):
    out, _, _ = straight
    run(F64 + EXACT, tmp_path, 2 * B)
    run(F64 + EXACT, tmp_path, 4 * B, "--resume")
    a, b = checkpoint(out, 4 * B), checkpoint(tmp_path, 4 * B)
    assert a["iteration"] == b["iteration"] == 4
    assert a["adam"]["count"] == b["adam"]["count"]
    for k in ("params", "obs"):
        assert torch.equal(a[k], b[k]), k
    for k in ("mu", "nu"):
        assert torch.equal(a["adam"][k], b["adam"][k]), k
    for k, v in a["env_state"].items():
        assert torch.equal(v, b["env_state"][k]), k
    assert all(torch.equal(x, y)
               for x, y in zip(a["generators"], b["generators"]))
    assert log(tmp_path) == log(out)


@pytest.mark.parametrize("flags", [["--fused-rollout"], ["--fused-update"],
                                   ["--fused-update-bf16"],
                                   ["--population", "2", "--fused-rollout"]])
def test_float64_with_a_fused_kernel_is_refused(flags, tmp_path):
    with pytest.raises(ValueError, match="float32"):
        run(F64 + flags, tmp_path, B)
    assert not os.path.exists(tmp_path / "r")


def test_float64_follows_the_float32_run(straight, tmp_path):
    out, _, _ = straight
    run(TINY + EXACT, tmp_path, 2 * B)
    a = checkpoint(tmp_path, 2 * B)
    b = torch.load(os.path.join(out, "r", "checkpoints", str(2 * B),
                                "state.pt"), weights_only=True)
    assert a["params"].dtype == torch.float32
    diff = (a["params"].double() - b["params"]).abs().max()
    assert 0 < float(diff) < 1e-4
