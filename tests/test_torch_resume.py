"""Resume of the port's training driver on the CPU at a tiny shape (64 envs
x 32 steps, minibatch 512, 2 epochs; checkpoints every iteration).

Four iterations straight equal two, then `--resume` for two more, bit for
bit: params, Adam state, env state, generators and the train log's rows
(solo with `--exact-eval`, and `--population 2`), and so does a run
stopped by a Ctrl-C and resumed.  With `--exact-eval`
the eval rows after the resume equal the straight run's too, whether the
resumed process counts the evals done from `checkpoints/eval_counts.json`
or, with that deleted, from the distinct steps of `eval.jsonl`.  The
port's `count_prior_evals` answers as JAX `train.count_prior_evals` on
the same run-dir fixtures, and `summary.json` has JAX's keys less those
the port leaves out, with `device`, the kernels' `launches` and the
`process_group` added."""

import ast
import json
import os
import shutil

import pytest
import torch

import train as jtrain
from acas2d_tpu.ppo.config import PPOConfig as JPPOConfig
from acas2d_tpu_torch import train
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.utils.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 64 * 32
TINY = ["--preset", "tpu", "--fused-rollout", "--fused-update",
        "--device", "cpu", "--n-envs", "64", "--n-steps", "32", "--minibatch-size", "512", "--n-epochs", "2",
        "--eval-episodes", "2", "--checkpoint-every", str(B),
        "--run-name", "r"]
SOLO = TINY + ["--exact-eval", "--eval-every", str(2 * B)]
POP = TINY + ["--population", "2", "--reval-episodes", "0",
              "--eval-every", str(64 * B)]
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


def _train(argv, out, total, resume=False):
    args = argv + ["--total-steps", str(total), "--out-dir", str(out)]
    return train.run(train.parse_args(args + (["--resume"] if resume
                                              else [])))


def _log(run_dir, name):
    with open(os.path.join(run_dir, f"{name}.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in TIMING} for line in f]


def _final(run_dir, step):
    return torch.load(os.path.join(run_dir, "checkpoints", str(step),
                                   "state.pt"), weights_only=True)


def _assert_same_checkpoint(a, b):
    assert a["iteration"] == b["iteration"]
    assert a["adam"]["count"] == b["adam"]["count"]
    for k in ("params", "obs"):
        assert torch.equal(a[k], b[k]), k
    for k in ("mu", "nu"):
        assert torch.equal(a["adam"][k], b["adam"][k]), k
    for k, v in a["env_state"].items():
        assert torch.equal(v, b["env_state"][k]), k
    assert all(torch.equal(x, y)
               for x, y in zip(a["generators"], b["generators"]))


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    """(straight run dir, the first half's run dir) of the solo run."""
    root = tmp_path_factory.mktemp("solo")
    _train(SOLO, root / "straight", 4 * B)
    _train(SOLO, root / "half", 2 * B)
    return root / "straight" / "r", root / "half" / "r"


@pytest.mark.parametrize("counts", ["eval_counts", "eval_log"])
def test_solo_resume_is_exact(solo, counts, tmp_path, capsys):
    straight, half = solo
    run_dir = tmp_path / "r"
    shutil.copytree(half, run_dir)
    if counts == "eval_log":
        os.remove(run_dir / "checkpoints" / "eval_counts.json")
        # a crash-then-resume cycle logs an eval twice: count it once
        with open(run_dir / "eval.jsonl") as f:
            lines = f.readlines()
        with open(run_dir / "eval.jsonl", "a") as f:
            f.write(lines[-1])
    assert train.count_prior_evals(str(run_dir), 2 * B,
                                   train.build_config(train.parse_args(
                                       SOLO))) == 2
    capsys.readouterr()
    rows = _train(SOLO, tmp_path, 4 * B, resume=True)
    assert f"resumed from step {2 * B}" in capsys.readouterr().err
    assert [r["iteration"] for r in rows] == [3, 4]
    _assert_same_checkpoint(_final(run_dir, 4 * B), _final(straight, 4 * B))
    assert _log(run_dir, "train") == _log(straight, "train")
    evals = _log(straight, "eval")
    assert [r["global_step"] for r in evals] == [B, 2 * B, 4 * B]
    assert _log(run_dir, "eval")[-1] == evals[-1]      # the Mersenne stream
    with open(run_dir / "checkpoints" / "eval_counts.json") as f:
        assert json.load(f)[str(4 * B)] == 3


@pytest.fixture(scope="module")
def population_straight(tmp_path_factory):
    root = tmp_path_factory.mktemp("population")
    _train(POP, root, 4 * B)
    return root / "r"


def test_population_resume_is_exact(population_straight, tmp_path, capsys):
    _train(POP, tmp_path, 2 * B)
    capsys.readouterr()
    rows = _train(POP, tmp_path, 4 * B, resume=True)
    assert f"resumed from step {2 * B}" in capsys.readouterr().err
    assert [r["iteration"] for r in rows] == [3, 4]
    straight, split = population_straight, tmp_path / "r"
    a, b = _final(straight, 4 * B), _final(split, 4 * B)
    assert a["kind"] == "population" and len(a["generators"]) == 2
    _assert_same_checkpoint(a, b)
    assert _log(split, "train") == _log(straight, "train")
    assert len(_log(split, "train")) == 4
    # the tracker's archive was flushed with the checkpoints and reloaded
    assert os.path.exists(split / "population_best.npz")


def test_a_run_stopped_by_ctrl_c_resumes_exactly(tmp_path, monkeypatch,
                                                 capsys):
    """--anneal-lr sizes the learning-rate schedule by the budget, so the
    first process keeps it and is stopped by a Ctrl-C inside its third
    iteration, after that iteration's draws: it saves its last whole
    iteration with the generators rewound, and --resume continues."""
    argv = TINY + ["--anneal-lr", "--eval-every", str(64 * B)]
    _train(argv, tmp_path / "straight", 4 * B)
    real = learner.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def interrupted(state, *a, **k):
            out = step(state, *a, **k)
            if out[0].iteration > 2:
                raise KeyboardInterrupt
            return out
        return interrupted

    monkeypatch.setattr(learner, "make_train_step", make)
    rows = _train(argv, tmp_path / "split", 4 * B)
    assert [r["iteration"] for r in rows] == [1, 2]
    assert "interrupted; saving checkpoint" in capsys.readouterr().err
    monkeypatch.setattr(learner, "make_train_step", real)
    _train(argv, tmp_path / "split", 4 * B, resume=True)
    straight, split = tmp_path / "straight" / "r", tmp_path / "split" / "r"
    assert CheckpointManager(str(split / "checkpoints")).steps() == [
        B, 2 * B, 3 * B, 4 * B]
    _assert_same_checkpoint(_final(split, 4 * B), _final(straight, 4 * B))
    assert _log(split, "train") == _log(straight, "train")


def test_resume_without_checkpoint_starts_fresh(tmp_path, capsys):
    rows = _train(SOLO, tmp_path, 0, resume=True)
    assert rows == []
    assert "no checkpoint found; starting fresh" in capsys.readouterr().err
    assert os.path.exists(tmp_path / "r" / "checkpoints" / "0" / "state.pt")


def test_polish_stage_checkpoints_at_its_end(tmp_path):
    args = train.parse_args(POP + ["--polish-steps", "4096"])
    argv = train.polish_argv(args, str(tmp_path), "r")
    assert argv[argv.index("--checkpoint-every") + 1] == "4096"


# ------------------------------------------------- held against JAX train.py

def _fixture(run_dir, kind):
    ckpt = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckpt)
    if kind in ("counts", "counts_other_step"):
        with open(os.path.join(ckpt, "eval_counts.json"), "w") as f:
            json.dump({"4096" if kind == "counts" else "999": 7}, f)
    if kind in ("eval_log", "counts_other_step"):
        with open(os.path.join(run_dir, "eval.jsonl"), "w") as f:
            for step in (0, 2048, 2048, 4096, 6144, 4096, 8192):
                f.write(json.dumps({"global_step": step,
                                    "eval_return_mean": 1.0}) + "\n")
            f.write("not json\n")


@pytest.mark.parametrize("kind", ["counts", "counts_other_step", "eval_log",
                                  "nothing"])
@pytest.mark.parametrize("restored", [0, 2048, 4096, 7000])
def test_count_prior_evals_matches_jax(kind, restored, tmp_path):
    _fixture(str(tmp_path), kind)
    want = jtrain.count_prior_evals(str(tmp_path), restored,
                                    JPPOConfig(eval_every_steps=2048))
    got = train.count_prior_evals(str(tmp_path), restored,
                                  PPOConfig(eval_every_steps=2048))
    assert got == want


def test_eval_counts_are_read_by_both_drivers(tmp_path):
    train.record_eval_count(str(tmp_path), 4096, 3)
    train.record_eval_count(str(tmp_path), 8192, 5)
    jtrain.record_eval_count(str(tmp_path), 6144, 4)
    for step, n in ((4096, 3), (6144, 4), (8192, 5)):
        cfg = PPOConfig()
        assert train.count_prior_evals(str(tmp_path), step, cfg) == n
        assert jtrain.count_prior_evals(str(tmp_path), step, JPPOConfig()) == n


def _jax_summary_keys():
    """The keys JAX train.py's main() writes into summary.json."""
    with open(os.path.join(ROOT, "train.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if (isinstance(target, ast.Name) and target.id == "summary"
                and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(target, ast.Subscript)
                and isinstance(target.value, ast.Name)
                and target.value.id == "summary"):
            keys.add(target.slice.value)
    return keys


def test_summary_has_jax_keys(solo, population_straight):
    jax_keys = _jax_summary_keys()
    left_out = {"compile_cache"}
    population_only = {"aggregate_steps_per_s", "population_selection"}
    assert left_out | population_only <= jax_keys
    with open(solo[0] / "summary.json") as f:
        summary = json.load(f)
    assert set(summary) == (jax_keys - left_out - population_only
                            | {"device", "launches", "process_group"})
    assert summary["population"] is None and summary["device"] == "cpu"
    assert summary["n_devices"] == 1 and summary["process_group"] is None
    assert summary["launches"] == {"policy_rollout": 0, "ppo_grads": 0,
                                   "adv_norm": 0}
    assert summary["global_step"] == summary["steps_this_process"] == 4 * B
    assert summary["iters_per_call"] == 1          # JAX's default on a CPU
    assert {"dispatch_s", "train_first_call_s", "train_step_s", "log_s",
            "checkpoint_s", "eval_s", "best_ckpt_s"} <= set(summary["phases"])
    assert summary["phases"]["train_step_calls"] == 3
    assert summary["argv"][:len(SOLO)] == SOLO
    with open(population_straight / "summary.json") as f:
        summary = json.load(f)
    assert set(summary) == jax_keys - left_out | {"device", "launches",
                                                  "process_group"}
    assert summary["population"] == 2
