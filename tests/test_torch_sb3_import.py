"""The port's SB3 policy import (`acas2d_tpu_torch/compat/sb3_import.py`)
against the JAX package's (`acas2d_tpu/compat/sb3_import.py`), on the CPU.

  * A zip whose `policy.pth` is a random state dict under SB3's layer
    names (made from a numpy seed, saved with `torch.save` of a plain
    dict): the port's flax-shaped tree equals JAX's `load_sb3_policy` of
    the same zip leaf for leaf, bit for bit, in float32 and float64; its
    state dict is SB3's tensors renamed, untransposed.
  * The port's forward with the imported state dict against flax's
    `ActorCritic.apply` with JAX's tree on seeded observations, within
    1e-6.
  * The tree written by `save_params_npz` loads in `eval --params-npz` on
    the CPU, as the same params.
  * A missing SB3 key raises KeyError, as JAX's does.
  * `tests/test_sb3_parity.py`'s two reference-zip cases, through the
    port's engine; they skip, as JAX's do, when
    `utils/reference.reference_path` finds no zip.
"""

import io
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acas2d_tpu.compat import sb3_import as jax_sb3
from acas2d_tpu.models.actor_critic import ActorCritic as FlaxActorCritic
from acas2d_tpu_torch import eval as eval_driver
from acas2d_tpu_torch.compat import sb3_import
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.models.actor_critic import (ActorCritic, N_PARAMS,
                                                  OBS_DIM, flatten)
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.utils.params_io import save_params_npz
from acas2d_tpu_torch.utils.reference import reference_path

# SB3 MlpPolicy's policy.pth: name -> shape
SB3_SHAPES = {
    "log_std": (1,),
    "mlp_extractor.policy_net.0.weight": (64, OBS_DIM),
    "mlp_extractor.policy_net.0.bias": (64,),
    "mlp_extractor.policy_net.2.weight": (64, 64),
    "mlp_extractor.policy_net.2.bias": (64,),
    "mlp_extractor.value_net.0.weight": (64, OBS_DIM),
    "mlp_extractor.value_net.0.bias": (64,),
    "mlp_extractor.value_net.2.weight": (64, 64),
    "mlp_extractor.value_net.2.bias": (64,),
    "action_net.weight": (1, 64),
    "action_net.bias": (1,),
    "value_net.weight": (1, 64),
    "value_net.bias": (1,),
}


def sb3_state_dict(seed=0, drop=None):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(0.0, 0.3, s).astype(np.float32))
            for k, s in SB3_SHAPES.items() if k != drop}


def write_zip(path, sd):
    """An SB3-shaped model zip: `policy.pth` beside SB3's other members."""
    buf = io.BytesIO()
    torch.save(sd, buf)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("data", "{}")
        z.writestr("policy.pth", buf.getvalue())
        z.writestr("_stable_baselines3_version", "2.3.2")
    return str(path)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and the eval's loop of small ops slows down many-fold when the
    workers' threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sb3_zip(tmp_path_factory):
    sd = sb3_state_dict()
    return write_zip(tmp_path_factory.mktemp("sb3") / "model.zip", sd), sd


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dtype,np_dtype", [(torch.float32, np.float32),
                                            (torch.float64, np.float64)])
def test_tree_equals_jax_import_bit_for_bit(sb3_zip, dtype, np_dtype):
    path, raw = sb3_zip
    sd, tree = sb3_import.load_sb3_policy(path, dtype)
    want = leaves(jax_sb3.load_sb3_policy(path, np_dtype))
    got = leaves(tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype == np_dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k
    # the state dict is SB3's tensors renamed: no transpose
    for sb3, port in sb3_import.SB3_LAYERS.items():
        for leaf in ("weight", "bias"):
            assert sd[f"{port}.{leaf}"].dtype == dtype
            assert torch.equal(sd[f"{port}.{leaf}"],
                               raw[f"{sb3}.{leaf}"].to(dtype))
    assert set(sd) == set(ActorCritic().state_dict())


def test_forward_agrees_with_flax(sb3_zip):
    path, _ = sb3_zip
    sd, _ = sb3_import.load_sb3_policy(path)
    model = ActorCritic()
    model.load_state_dict(sd)
    obs = np.random.default_rng(1).normal(0.0, 1.0, (256, OBS_DIM)).astype(
        np.float32)
    with torch.no_grad():
        mean, log_std, value = model(torch.from_numpy(obs))
    jmean, jlog_std, jvalue = FlaxActorCritic().apply(
        jax_sb3.load_sb3_policy(path), jnp.asarray(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(log_std.numpy(), np.asarray(jlog_std))


def test_npz_round_trip_loads_in_eval(sb3_zip, tmp_path):
    path, _ = sb3_zip
    sd, tree = sb3_import.load_sb3_policy(path)
    npz = str(tmp_path / "model.npz")
    save_params_npz(npz, tree)
    args = eval_driver.parse_args(["--params-npz", npz, "--episodes", "2",
                                   "--device", "cpu", "--out",
                                   str(tmp_path / "eval_2.csv")])
    model = ActorCritic()
    model.load_state_dict(sd)
    assert torch.equal(eval_driver.load_params(args), flatten(model))
    assert eval_driver.load_params(args).shape == (N_PARAMS,)
    summary = eval_driver.run(args)
    assert summary["episodes"] == 2
    assert np.isfinite(summary["mean_reward"])
    assert os.path.exists(tmp_path / "eval_2.csv")


@pytest.mark.parametrize("drop", ["action_net.bias", "log_std",
                                  "mlp_extractor.value_net.2.weight"])
def test_missing_key_raises(tmp_path, drop):
    path = write_zip(tmp_path / "partial.zip", sb3_state_dict(drop=drop))
    with pytest.raises(KeyError, match=drop):
        sb3_import.load_sb3_policy(path)
    with pytest.raises(KeyError, match=drop):
        jax_sb3.load_sb3_policy(path)


BEST = reference_path("gym_ACAS2D", "models", "best_model_1048576_11",
                      "best_model.zip")
needs_reference = pytest.mark.skipif(
    not os.path.exists(BEST), reason="reference checkpoint unavailable")


@needs_reference
def test_reference_policy_reproduces_recorded_reward():
    """tests/test_sb3_parity.py's first case: the reference's trained
    policy, imported, on 30 Mersenne episodes of the port's float64
    engine."""
    sd, _ = sb3_import.load_sb3_policy(BEST)
    model = ActorCritic()
    model.load_state_dict(sd)
    ep = learner.exact_episodes(
        flatten(model), DEFAULT_PARAMS,
        MersenneSpawner(DEFAULT_PARAMS, skip_episodes=2), 30, torch.float64,
        "cpu")
    outcome = ep["outcome"].numpy()
    ret = ep["return"].numpy()
    length = ep["length"].numpy()
    assert (outcome == 1).all(), f"non-goal outcomes: {outcome}"
    assert 1100 < ret.mean() < 1330, ret.mean()
    assert 600 < length.mean() < 820, length.mean()


@needs_reference
def test_sb3_import_roundtrip_shapes():
    sd, tree = sb3_import.load_sb3_policy(BEST)
    model = ActorCritic()
    model.load_state_dict(sd)
    with torch.no_grad():
        mean, log_std, value = model(torch.zeros(4, OBS_DIM))
    assert mean.shape == (4, 1) and value.shape == (4,)
    assert torch.isfinite(mean).all()
    ref = FlaxActorCritic().init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, OBS_DIM)))
    assert (jax.tree_util.tree_structure(ref)
            == jax.tree_util.tree_structure(jax.tree.map(jnp.asarray, tree)))
