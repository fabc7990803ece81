"""`python -m acas2d_tpu_torch.sub_minute` (the port of
scripts/sub_minute.sh), on the CPU.

  * SUB_MINUTE_ARGV is the script's `train.py` command, less the `--seed`
    and `--run-name` set per run.
  * A cut run (P = 2 members of 64 envs x 16 steps, one iteration and a
    one-iteration polish, warm-started from the flagship so that the
    greedy evals end early, one thread): the polish stage's
    population.json carries `training_wall_s` beside the merge record the
    polish chaining wrote (`stage1`, `pipeline`), and the strict eval's
    CSV holds its episodes, their mean the summary's.
  * A run that raises ends the command before any eval.
"""

import json
import os
import shlex

import numpy as np
import pytest
import torch

from acas2d_tpu_torch import sub_minute, train
from acas2d_tpu_torch.utils.episode_csv import read_csv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.npz")
TINY = ["--preset", "tpu", "--anneal-lr", "--population", "2",
        "--fused-rollout", "--fused-update-packed", "--n-envs", "64",
        "--n-steps", "16", "--minibatch-size", "512", "--n-epochs", "1",
        "--total-steps", "1024", "--checkpoint-every", "1024",
        "--eval-episodes", "2", "--reval-episodes", "2",
        "--polish-steps", "1024", "--polish-pop", "2",
        "--init-params-npz", FLAGSHIP]
EPISODES = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_argv_is_the_scripts_command():
    with open(os.path.join(ROOT, "scripts", "sub_minute.sh")) as f:
        text = f.read()
    start = text.index("python train.py")
    cmd = shlex.split(text[start:text.index("\nt1=", start)]
                      .replace("\\\n", " "))[2:]
    for flag in ("--seed", "--run-name"):          # set per run
        i = cmd.index(flag)
        del cmd[i:i + 2]
    assert cmd == sub_minute.SUB_MINUTE_ARGV


def test_cut_run_records_its_wall_and_strict_eval(tmp_path):
    out = str(tmp_path)
    rec = sub_minute.run_sub_minute(11, "tiny", TINY, out, device="cpu",
                                    eval_episodes=EPISODES)
    polish = os.path.join(out, "tiny_s11_polish")
    assert rec["polish"] == polish
    assert os.path.isdir(os.path.join(out, "tiny_s11"))
    with open(os.path.join(polish, "population.json")) as f:
        pop = json.load(f)
    assert pop["training_wall_s"] == round(rec["training_wall_s"], 1) > 0
    assert {"stage1", "pipeline", "selected_member",
            "selected_score"} <= set(pop)
    assert pop["population"] == 2 and pop["stage1"]["population"] == 2
    rows = read_csv(os.path.join(polish, f"eval_{EPISODES}_exact.csv"))
    strict = rec["strict"]
    assert len(rows) == strict["episodes"] == EPISODES
    assert strict["dtype"] == "float64" and strict["device"] == "cpu"
    assert float(np.mean([r["Total Reward"] for r in rows])) == \
        strict["mean_reward"]
    assert sum(r["Outcome"] == "Goal" for r in rows) == strict["goals"]


def test_a_raising_run_ends_the_command(tmp_path, monkeypatch):
    evals = []
    monkeypatch.setattr(train, "main",
                        lambda argv: (_ for _ in ()).throw(
                            RuntimeError("kernel launch failed")))
    monkeypatch.setattr(sub_minute.eval_driver, "run",
                        lambda *a, **k: evals.append(a))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        sub_minute.main(["5", "--out-dir", str(tmp_path), "--device", "cpu"])
    assert evals == []
