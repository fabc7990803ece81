"""The port's configuration copies equal the JAX package's, field by field
and property by property (exact equality: both are the same Python floats)."""

import dataclasses

import pytest

from acas2d_tpu import config as jcfg
from acas2d_tpu.ppo import config as jppo
from acas2d_tpu_torch import config as tcfg
from acas2d_tpu_torch.ppo import config as tppo


def _properties(cls):
    return [n for n, v in vars(cls).items() if isinstance(v, property)]


@pytest.mark.parametrize("kw", [{}, {"bug_compat": False, "max_traffic": 3},
                                {"width": 1200.0, "fps": 50.0}])
def test_env_params_match(kw):
    j, t = jcfg.EnvParams(**kw), tcfg.EnvParams(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert _properties(jcfg.EnvParams) == _properties(tcfg.EnvParams)
    for name in _properties(jcfg.EnvParams):
        assert getattr(j, name) == getattr(t, name), name
    assert jcfg.OUTCOME_NAMES == tcfg.OUTCOME_NAMES
    assert dataclasses.asdict(jcfg.DEFAULT_PARAMS) == dataclasses.asdict(
        tcfg.DEFAULT_PARAMS)


@pytest.mark.parametrize("make", ["reference_config", "tpu_default"])
def test_ppo_config_match(make):
    j, t = getattr(jppo, make)(), getattr(tppo, make)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for name in _properties(jppo.PPOConfig):
        assert getattr(j, name) == getattr(t, name), name
    if make == "tpu_default":          # the main path's shape
        assert (t.n_envs, t.n_steps, t.minibatch_size, t.n_epochs,
                t.shuffle_block, t.n_minibatches) == (2048, 128, 65536, 10,
                                                      512, 4)
