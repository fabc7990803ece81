"""`python -m acas2d_tpu_torch.eval --run DIR [--best | --step N]` on the
CPU: it scores a checkpoint of a port training run as `--params-npz`
scores the same params written with `utils/params_io.save_params_npz`
(the same summary), and the JAX `ActorCritic` on that npz gives the port's
action means.  The run is warm-started from the flagship policy, so its
greedy episodes end early and the evals stay short."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acas2d_tpu.models.actor_critic import ActorCritic as JActorCritic
from acas2d_tpu.utils.params_io import load_params_npz as jload_params_npz
from acas2d_tpu_torch import eval as teval
from acas2d_tpu_torch import train
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.models.actor_critic import ActorCritic, apply_flat
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import tpu_default
from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
from acas2d_tpu_torch.utils.params_io import flat_to_tree, save_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.npz")
B = 64 * 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    train.run(train.parse_args([
        "--preset", "tpu", "--fused-rollout", "--fused-update",
        "--device", "cpu", "--n-envs", "64",
        "--n-steps", "32", "--minibatch-size", "512", "--n-epochs", "2",
        "--total-steps", str(2 * B), "--eval-every", str(B),
        "--eval-episodes", "2", "--checkpoint-every", str(B),
        "--init-params-npz", FLAGSHIP, "--out-dir", str(out),
        "--run-name", "r"]))
    return out / "r"


def _eval(argv, out):
    """The exact eval of 3 episodes, its episode CSV written to `out`."""
    return teval.run(teval.parse_args(argv + ["--episodes", "3", "--exact",
                                              "--out", str(out),
                                              "--device", "cpu"]))


@pytest.mark.parametrize("which", [["--best"], ["--step", str(B)], []],
                         ids=["best", "step", "latest"])
def test_run_checkpoint_scores_as_its_params_npz(which, run_dir, tmp_path,
                                                 capsys):
    mgr = CheckpointManager(str(run_dir / "checkpoints"))
    if which == ["--best"]:
        raw = mgr.restore_raw(best=True)
        with open(run_dir / "checkpoints" / "best" / "best_value.json") as f:
            assert json.load(f)["step"] in (B, 2 * B)
    else:
        raw = mgr.restore_raw(step=int(which[1]) if which else None)
        assert raw["iteration"] == (1 if which else 2)
    npz = str(tmp_path / "p.npz")
    save_params_npz(npz, flat_to_tree(raw["params"]))
    capsys.readouterr()
    got = _eval(["--run", str(run_dir)] + which, tmp_path / "run.csv")
    assert (f"loaded checkpoint (iteration {raw['iteration']})"
            in capsys.readouterr().err)
    want = _eval(["--params-npz", npz], tmp_path / "npz.csv")
    assert got == want
    assert ((tmp_path / "run.csv").read_bytes()
            == (tmp_path / "npz.csv").read_bytes())
    assert got["goals"] + got["collisions"] + got["timeouts"] == 3


def test_jax_model_on_the_npz_gives_the_port_means(run_dir, tmp_path):
    raw = CheckpointManager(str(run_dir / "checkpoints")).restore_raw(
        best=True)
    npz = str(tmp_path / "p.npz")
    save_params_npz(npz, flat_to_tree(raw["params"]))
    _, obs = vector.reset_batch(16, DEFAULT_PARAMS,
                                torch.Generator().manual_seed(4),
                                torch.float32, "cpu")
    port = apply_flat(ActorCritic(), raw["params"], obs)[0][:, 0]
    jparams = jload_params_npz(npz)
    jmean = JActorCritic().apply(
        {"params": {k: v for k, v in jparams["params"].items()}},
        jnp.asarray(obs.numpy()))[0][:, 0]
    np.testing.assert_allclose(port.numpy(), np.asarray(jmean), rtol=1e-6,
                               atol=0)


def test_population_checkpoint_is_refused(tmp_path):
    cfg = tpu_default(n_envs=64, n_steps=32, minibatch_size=512)
    mgr = CheckpointManager(str(tmp_path / "checkpoints"))
    mgr.save(B, learner.state_to_dict(
        population.init_population(cfg, DEFAULT_PARAMS, 2, "cpu")))
    with pytest.raises(ValueError, match="population run"):
        _eval(["--run", str(tmp_path)], tmp_path / "eval.csv")


@pytest.mark.parametrize("argv", [["--run", "d", "--params-npz", "p"],
                                  ["--params-npz", "p", "--best"],
                                  ["--params-npz", "p", "--step", "4"],
                                  ["--run", "d", "--best", "--step", "4"],
                                  []])
def test_exactly_one_source_is_required(argv, capsys):
    with pytest.raises(SystemExit):
        teval.parse_args(argv)
    assert "error" in capsys.readouterr().err
