"""`python -m acas2d_tpu_torch.export_population_artifacts` against the JAX
script it ports (`scripts/export_population_artifacts.py`), on the CPU.

  * `strict_record` of one episode CSV (read without pandas) against JAX's
    (pandas): every numeric field equal, the strings naming the port's
    command.
  * A `--stage final` export of a synthetic pipeline dir through both
    (JAX's from a copy under the test's temporary directory, whose REPO is
    that directory): the selected policy and population.json copied byte
    for byte, the strict records' numeric fields equal.
  * `artifacts/` and any path under it are refused as the output
    directory.
"""

import csv
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

from acas2d_tpu_torch import export_population_artifacts as exporter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.npz")
NUMERIC = ("episodes", "mean_reward", "std_reward", "goals", "collisions",
           "timeouts", "mean_steps")


def write_strict_csv(path, seed=0, n=100):
    """An episode CSV with the reference's columns that the record reads,
    a list column among them (as the eval writes its paths)."""
    rng = np.random.default_rng(seed)
    outcomes = rng.choice(["Goal", "Goal", "Goal", "Collision", "Timeout"],
                          n)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Episode", "Outcome", "Total Reward", "Time Steps",
                    "Player Path"])
        for i in range(n):
            path_text = str([(float(rng.normal()), float(rng.normal()))
                             for _ in range(3)])
            w.writerow([i + 1, outcomes[i], repr(float(rng.normal(1200, 70))),
                        int(rng.integers(500, 1001)), path_text])
    return str(path)


def jax_script(base):
    os.makedirs(base / "scripts")
    src = shutil.copy(os.path.join(ROOT, "scripts",
                                   "export_population_artifacts.py"),
                      base / "scripts")
    spec = importlib.util.spec_from_file_location("jax_pop_export", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_strict_record_equals_jax(tmp_path, seed):
    csv_path = write_strict_csv(tmp_path / "eval_100_exact.csv", seed)
    jmod = jax_script(tmp_path / "jax")
    got = exporter.strict_record(csv_path, "x.npz", "made here")
    want = jmod.strict_record(csv_path, "x.npz", "made here")
    assert set(got) == set(want)
    for k in NUMERIC:
        assert got[k] == want[k] and type(got[k]) is type(want[k]), k
    assert got["goals"] + got["collisions"] + got["timeouts"] == 100
    assert got["produced_by"] == ["made here"]
    assert got["reproduce"] == ("python -m acas2d_tpu_torch.eval "
                                "--params-npz x.npz --exact --episodes 100")
    assert got["protocol"].startswith("python -m acas2d_tpu_torch.eval")


def make_final_dir(run):
    os.makedirs(run)
    shutil.copy(FLAGSHIP, run / "selected_best.npz")
    with open(run / "population.json", "w") as f:
        json.dump({"selected_score": 1234.5, "best_of_chain": "x",
                   "training_wall_s": 400.1, "attempts": 1}, f, indent=1)
    write_strict_csv(run / "eval_100_exact.csv", seed=5)


def test_final_stage_export_equals_jax(tmp_path, capsys):
    # the JAX script reads <REPO>/runs/ppo and writes <REPO>/artifacts
    jax_base = tmp_path / "jax"
    make_final_dir(jax_base / "runs" / "ppo" / "pipe_s2101_final")
    jmod = jax_script(jax_base)
    assert jmod.main(["--run-prefix", "pipe", "--seeds", "2101",
                      "--stage", "final", "--art-prefix", "p5"]) == 0
    runs = tmp_path / "runs"
    make_final_dir(runs / "pipe_s2101_final")
    out = tmp_path / "out"
    assert exporter.main(["--run-prefix", "pipe", "--seeds", "2101",
                          "--stage", "final", "--art-prefix", "p5",
                          "--runs-dir", str(runs),
                          "--out-dir", str(out)]) == 0
    assert "seed 2101: strict" in capsys.readouterr().out
    jax_out = jax_base / "artifacts" / "population"
    names = ["p5_s2101_selected.npz", "p5_s2101_population.json",
             "p5_s2101_strict.json"]
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out)) == sorted(
        names)
    for name in names[:2]:
        assert (out / name).read_bytes() == (jax_out / name).read_bytes()
    with open(out / names[2]) as f:
        got = json.load(f)
    with open(jax_out / names[2]) as f:
        want = json.load(f)
    for k in NUMERIC:
        assert got[k] == want[k], k
    assert got["reproduce"].endswith(f"{out / names[0]} --exact "
                                     f"--episodes 100")


@pytest.mark.parametrize("sub", ["artifacts", "artifacts/population"])
def test_artifacts_dir_is_refused(tmp_path, sub, capsys):
    make_final_dir(tmp_path / "runs" / "pipe_s1_final")
    before = sorted(os.listdir(os.path.join(ROOT, "artifacts", "population")))
    with pytest.raises(SystemExit) as e:
        exporter.main(["--run-prefix", "pipe", "--seeds", "1", "--stage",
                       "final", "--runs-dir", str(tmp_path / "runs"),
                       "--out-dir", os.path.join(ROOT, sub)])
    assert e.value.code == 2
    assert "refusing" in capsys.readouterr().err
    assert sorted(os.listdir(os.path.join(ROOT, "artifacts",
                                          "population"))) == before
