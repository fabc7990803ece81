"""The port's training driver reads a JAX command line as JAX's does, and
refuses only what it does not run.

* `train.build_config` against the JAX driver's `train.build_config`,
  field by field, over command lines that touch every path flag: none,
  `--preset tpu`, each fused flag, `--fused-update-packed`,
  `--fused-update-bf16` (both imply the fused update, as in JAX),
  `--population 4` and `--dtype float64`.  The defaults are JAX's: the
  fused paths are off unless asked for.
* `learner.check_ported`: every (fused_rollout, fused_update) pair in
  float32, solo and population (the step builders call it); in float64
  only the unfused pair, since both kernels compute in float32; never
  `update_remat`.
"""

import dataclasses
import itertools

import pytest
import torch

import train as jtrain
from acas2d_tpu_torch import train
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig

ARGVS = [[], ["--preset", "tpu"], ["--fused-rollout"], ["--fused-update"],
         ["--fused-rollout", "--fused-update"], ["--fused-update-packed"],
         ["--fused-update-bf16"], ["--population", "4"],
         ["--dtype", "float64"],
         ["--preset", "tpu", "--population", "4", "--fused-rollout",
          "--fused-update-packed", "--n-envs", "1024",
          "--minibatch-size", "32768", "--anneal-lr"]]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_build_config_equals_jax(argv):
    port = train.build_config(train.parse_args(argv))
    jax_cfg = jtrain.build_config(jtrain.parse_args(argv))
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    assert train.parse_args(argv).dtype == jtrain.parse_args(argv).dtype


def test_fused_paths_are_off_by_default():
    cfg = train.build_config(train.parse_args(["--preset", "tpu"]))
    assert not (cfg.fused_rollout or cfg.fused_update)
    spelled = train.build_config(train.parse_args(
        ["--preset", "tpu", "--no-fused-rollout", "--no-fused-update"]))
    assert spelled == cfg


@pytest.mark.parametrize("pop", [0, 2])
@pytest.mark.parametrize("fused_rollout,fused_update",
                         list(itertools.product([False, True], repeat=2)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_check_ported(pop, fused_rollout, fused_update, dtype):
    cfg = PPOConfig(n_envs=16, n_steps=8, minibatch_size=64,
                    fused_rollout=fused_rollout, fused_update=fused_update)
    build = ((lambda: population.make_population_step(
                 cfg, DEFAULT_PARAMS, "cpu", dtype=dtype)) if pop
             else (lambda: learner.make_train_step(cfg, DEFAULT_PARAMS,
                                                   "cpu", dtype=dtype)))
    if dtype == torch.float64 and (fused_rollout or fused_update):
        with pytest.raises(ValueError, match="float32"):
            learner.check_ported(cfg, dtype)
        with pytest.raises(ValueError, match="float32"):
            build()
    else:
        learner.check_ported(cfg, dtype)
        build()
    with pytest.raises(NotImplementedError, match="update_remat"):
        learner.check_ported(dataclasses.replace(cfg, update_remat=True),
                             dtype)


def test_a_step_refuses_a_state_of_another_dtype():
    cfg = PPOConfig(n_envs=16, n_steps=8, minibatch_size=64)
    step = learner.make_train_step(cfg, DEFAULT_PARAMS, "cpu")
    state = learner.init_train_state(cfg, DEFAULT_PARAMS, "cpu",
                                     dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        step(state)
