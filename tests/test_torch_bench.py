"""The port's env-stepping benchmark (`python -m acas2d_tpu_torch.bench`) on
the CPU at tiny shapes, through the plain versions: its measures, its three
modes, its JSON records (the JAX bench's keys plus the device), every JAX
training variant, and its refusals.  Rates measured here are
CPU rates of the plain versions and are only checked for being positive."""

import json

import pytest
import torch

from acas2d_tpu_torch import bench
from acas2d_tpu_torch.ops.env_rollout import fused_rollout

TINY = ["--device", "cpu", "--envs", "1024", "--steps", "8"]
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "value_with_obs",
                 "repeats", "repeats_with_obs", "device"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and the training variants' loops of small ops slow down many-fold when
    the workers' threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("with_obs", [False, True])
def test_measure_fused_counts_its_launches(with_obs):
    n0 = fused_rollout.launches
    rates = bench.measure_fused(B=1024, T=8, iters=2, repeats=3,
                                with_obs=with_obs, device="cpu")
    assert len(rates) == 3 and all(r > 0 for r in rates)
    assert fused_rollout.launches == n0          # no kernel on the CPU


def test_measure_fused_returns_the_chained_state():
    """With return_state the measure also gives the state its last launch
    left: the seeded reset flown 1 + iters x repeats launches of T steps
    with the bench's seed."""
    rates, st = bench.measure_fused(B=1024, T=4, iters=2, repeats=2,
                                    device="cpu", return_state=True)
    assert len(rates) == 2
    from acas2d_tpu_torch.config import DEFAULT_PARAMS
    from acas2d_tpu_torch.envs import vector
    from acas2d_tpu_torch.ops.env_rollout import flat_state
    s, _ = vector.reset_batch(1024, DEFAULT_PARAMS,
                              torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
    want = flat_state(s)
    for _ in range(5):
        want, _ = fused_rollout(want, bench.SEED, 4)
    for k, v in want.items():
        assert torch.equal(st[k], v), k


def test_headline_record_of_given_repeats():
    out = bench.headline_record([2.0, 3.0], [1.0], torch.device("cpu"))
    assert set(out) == HEADLINE_KEYS
    assert out["value"] == 3.0 and out["value_with_obs"] == 1.0
    assert out["repeats"] == [2.0, 3.0] and out["repeats_with_obs"] == [1.0]


@pytest.mark.parametrize("with_obs", [False, True])
def test_measure_general_engine(with_obs):
    rates = bench.measure(B=1024, T=8, iters=2, repeats=2, with_obs=with_obs,
                          device="cpu")
    assert len(rates) == 2 and all(r > 0 for r in rates)


def test_headline_line(capsys):
    assert bench.main(TINY) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == HEADLINE_KEYS
    assert out["unit"] == "env-steps/s/chip" and out["device"] == "cpu"
    assert out["value"] == max(out["repeats"]) > 0
    assert out["value_with_obs"] == max(out["repeats_with_obs"]) > 0
    assert out["vs_baseline"] == round(out["value"] / 100.0, 1)
    assert "CPU" in out["metric"]


def test_train_mode_and_not_ported(capsys):
    assert bench.main(["--device", "cpu", "--train", "--train-envs", "64",
                       "--train-steps", "4", "--train-minibatch",
                       "256"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["paths"]) == {"xla", "fused_rollout",
                                 "fused_rollout+loop32",
                                 "fused_rollout+update",
                                 "fused_rollout+update_bf16",
                                 "fused_rollout+update+loop32",
                                 "fused_rollout+update_bf16+loop32"}
    assert all(v > 0 for v in out["paths"].values())
    assert out["value"] == max(out["paths"].values())
    # every JAX variant runs: nothing is listed as missing, and the
    # 4096-env best case is the card's alone (2048 envs there)
    assert "not_ported" not in out and "best_case_4096" not in out
    assert not any("unavailable" in str(v) for v in out["paths"].values())
    assert out["device"] == "cpu" and out["n_envs"] == 64


def test_multi_traffic_mode(capsys):
    assert bench.main(["--device", "cpu", "--multi-traffic", "3",
                       "--mt-envs", "64"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["paths"]) == {"traffic1", "traffic3"}
    assert out["value"] == out["paths"]["traffic3"] > 0
    assert out["relative_cost"] > 0


def test_scaling_mode_without_a_launcher(capsys):
    """One process is a sweep of n = 1: a point with JAX's keys and the
    summary line (tests/test_torch_sharded_driver.py sweeps two ranks)."""
    assert bench.main(["--device", "cpu", "--scaling", "--envs-per-device",
                       "8", "--bench-steps", "4", "--train-steps", "8"]) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    point, summary = lines
    assert point["n_devices"] == 1 and point["platform"] == "cpu"
    assert point["rollout_steps_per_s"] > 0 and point["train_steps_per_s"] > 0
    assert summary["value"] == 1.0 and summary["target"] == 0.8
    assert summary["n_devices_max"] == 1 and summary["device"] == "cpu"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run(bench.parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.measure_fused(B=1024, T=2)
