"""The plain reference against the program's plain versions, at a tiny
size on the CPU, through the drivers: the first three PPO iterations
(losses, Adam's first moment, the params' change), the greedy evals, and
the env rollout's first and sampled launches."""

import pytest

from benchmark import spec
from conftest import measure, tiny


@pytest.mark.parametrize("name", ["pop32.attempt", "solo_tpu.train"])
def test_training_follows(name):
    nums = measure(tiny(name))["numbers"]
    for k in ("loss_gap.1", "loss_gap.2", "loss_gap.3"):
        assert nums[k] < 1e-5, (k, nums[k])
    assert nums["grad_gap"] < 1e-5
    assert nums["update_gap"] < 1e-5
    if "eval_gap" in nums:
        assert nums["eval_gap"] < 1e-3


def test_solo_evals_follow():
    """The solo eval path of the `attempt` mix (no cell runs it yet): the
    eval, the best checkpoint, and the reference's eval on its params."""
    cell = tiny("solo_tpu.train")
    cell.traffic = spec.load_cell("pop32.attempt").traffic
    cell.traffic["warm_seconds"] = 0.0
    rec = measure(cell)
    assert rec["work"]["evals"] >= 1
    assert rec["numbers"]["eval_gap"] < 1e-3


def test_env_rollout_follows():
    nums = measure(tiny("envstep.obs"))["numbers"]
    assert nums["env_flipped"] == 0.0
    assert nums["env_err"] < 1.0
