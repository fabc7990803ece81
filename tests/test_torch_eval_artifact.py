"""The port's exact evaluation of the committed flagship policy reproduces
its record (artifacts/ppo_tpu_e_polished_best.json: strict 100-episode
Mersenne protocol, float64 env, float32 policy): 1252.72 +- 72.04 with
100/100 goals, to the record's 2 decimals.

The record's std is the sample std (ddof 1); the JAX driver eval.py prints
the population std of the same returns (71.68), which the port reports as
`std_reward`.  The weights are carried across from the committed npz
(utils/params_io.from_jax_params)."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.npz")
RECORD = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.json")


def test_exact_eval_reproduces_flagship_record(tmp_path):
    with open(RECORD) as f:
        rec = json.load(f)["strict_100ep"]
    # one thread: 100 envs are too few for intra-op threads to pay, and the
    # suite runs several test workers side by side
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "acas2d_tpu_torch.eval", "--params-npz", NPZ,
         "--exact", "--episodes", "100", "--out",
         str(tmp_path / "eval_100.csv"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True,
        timeout=600)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["dtype"] == "float64" and res["episodes"] == 100
    assert res["goals"] == rec["goals"] == 100
    assert round(res["mean_reward"], 2) == rec["mean_reward"]
    assert round(res["std_reward_ddof1"], 2) == rec["std_reward"]
    assert round(res["std_reward"], 2) == 71.68      # eval.py's printout
    # one line per episode on stderr, as the JAX driver prints them
    assert len([l for l in out.stderr.splitlines()
                if l.startswith("Episode")]) == 100
    # the episode CSV: 100 rows, whose returns the summary averages (up to
    # the order of the sums)
    with open(tmp_path / "eval_100.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 100
    assert all(r["Outcome"] == "Goal" for r in rows)
    assert abs(np.mean([float(r["Total Reward"]) for r in rows])
               - res["mean_reward"]) < 1e-9


def test_eval_needs_cuda_unless_asked_for_cpu():
    import torch
    from acas2d_tpu_torch import eval as ev
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ev.run(ev.parse_args(["--params-npz", NPZ, "--episodes", "1"]))
