"""Shared helpers of the benchmark's own tests: cells cut to a size that
the CPU runs in seconds, on the program's plain versions.

    python -m pytest benchmark/tests -q
"""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run, spec  # noqa: E402

SEED = 2 ** 33 + 5        # past 32 signed bits, as the driver's are


def tiny(name: str):
    """Cell `name` at a tiny size: 16 envs x 16 steps (2 members), a
    minibatch of 128, 2 iterations a call, evals of 4 episodes; or 2048
    envs x 32 steps a launch."""
    cell = spec.load_cell(name)
    if cell.traffic["drive"] == "train":
        cell.config.update(n_envs=16, n_steps=16, minibatch_size=128,
                           iters_per_call=2, eval_episodes=4)
        if cell.config["population"]:
            cell.config["population"] = 2
    else:
        cell.config.update(n_envs=2048)
        cell.traffic.update(steps_per_launch=32, launches_per_sync=2)
    cell.traffic["warm_seconds"] = 0.0
    return cell


def measure(cell, seed=SEED, seconds=0.5, trace=False, controls=False):
    return run.measure(cell, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), controls)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
