"""`python -m acas2d_tpu_torch.export_parity_artifacts` against the JAX
script it ports (`scripts/export_parity_artifacts.py`), on the CPU.

  * The same synthetic sweep (run dirs holding an `eval.csv`) through both:
    every `*_evaluations.npz` array and the summary JSON equal.  The JAX
    script writes into `<its REPO>/artifacts`, REPO computed from its own
    path, so it runs from a copy under the test's temporary directory and
    never touches the repository; it is given no `checkpoints/best`, whose
    params it would restore with orbax.
  * A tiny CPU run's `checkpoints/best`, exported to an `.npz` whose params
    are the checkpoint's.
  * `artifacts/` and any path under it are refused as the output
    directory, and an empty sweep writes no summary.
"""

import csv
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from acas2d_tpu_torch import export_parity_artifacts as exporter
from acas2d_tpu_torch import train
from acas2d_tpu_torch.utils.checkpoint import CheckpointManager
from acas2d_tpu_torch.utils.params_io import load_flat_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = ("ref_s8", "ref_s9", "ref_s12", "env8_s2", "env8_s8",
        "exact_eval_ref_s12")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and the training run's loops of small ops slow down many-fold when the
    workers' threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_eval_csv(run_dir, rng, n=32):
    """An eval.csv with the port's columns, long float tails included."""
    os.makedirs(run_dir)
    cols = ["eval_return_mean", "eval_return_std", "eval_length_mean",
            "eval_goal_rate", "eval_collision_rate", "eval_done_all",
            "eval_seconds", "wall_time_s", "global_step"]
    with open(os.path.join(run_dir, "eval.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(n):
            w.writerow([repr(float(rng.normal(900, 300))),
                        repr(float(rng.uniform(0, 100))),
                        repr(float(rng.uniform(500, 1000))),
                        repr(float(rng.choice([0.0, 0.3, 0.7, 1.0]))),
                        0.0, 1.0, 1.5, 2.5, 32768 * (i + 1)])


def jax_script(tmp_path):
    """The JAX script, loaded from a copy whose REPO is `tmp_path/jax`."""
    base = tmp_path / "jax"
    os.makedirs(base / "scripts")
    os.makedirs(base / "artifacts")
    src = shutil.copy(os.path.join(ROOT, "scripts",
                                   "export_parity_artifacts.py"),
                      base / "scripts")
    spec = importlib.util.spec_from_file_location("jax_parity_export", src)
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod, base / "artifacts"


def test_exports_equal_the_jax_scripts(tmp_path):
    rng = np.random.default_rng(4)
    sweep = tmp_path / "sweep"
    for run in RUNS:
        write_eval_csv(sweep / run, rng)
    jmod, jax_out = jax_script(tmp_path)
    assert jmod.main([str(sweep)]) == 0
    port_out = tmp_path / "port"
    assert exporter.main([str(sweep), "--out-dir", str(port_out)]) == 0
    names = sorted(os.listdir(jax_out))
    assert names == sorted(os.listdir(port_out))
    assert len(names) == len(exporter.EXPORTS) + 1
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(port_out / name), np.load(jax_out / name)
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k],
                                                                   b[k]), k
    assert ((port_out / "parity_sweep_summary.json").read_bytes()
            == (jax_out / "parity_sweep_summary.json").read_bytes())
    with open(port_out / "parity_sweep_summary.json") as f:
        assert sorted(json.load(f)) == sorted(RUNS)


def test_best_checkpoint_exported_as_its_params(tmp_path):
    sweep = tmp_path / "sweep"
    train.main(["--device", "cpu", "--n-steps", "64", "--total-steps", "128",
                "--eval-every", "64", "--eval-episodes", "1",
                "--checkpoint-every", "64", "--seed", "8", "--run-name",
                "ref_s8", "--out-dir", str(sweep)])
    out = tmp_path / "out"
    assert exporter.main([str(sweep), "ref_s8", "--out-dir", str(out)]) == 0
    params, stack = load_flat_params(str(out / "ppo_ref_s8_best.npz"))
    want = CheckpointManager(str(sweep / "ref_s8" / "checkpoints")
                             ).restore_raw(best=True)["params"]
    assert stack is None and torch.equal(params, want)
    curve = np.load(out / "ppo_ref_s8_evaluations.npz")
    assert list(curve["timesteps"]) == [64, 128]


@pytest.mark.parametrize("sub", ["artifacts", "artifacts/parity",
                                 "artifacts/../artifacts/x"])
def test_artifacts_dir_is_refused(tmp_path, sub, capsys):
    rng = np.random.default_rng(0)
    write_eval_csv(tmp_path / "sweep" / "ref_s12", rng)
    before = sorted(os.listdir(os.path.join(ROOT, "artifacts")))
    with pytest.raises(SystemExit) as e:
        exporter.main([str(tmp_path / "sweep"), "ref_s12", "--out-dir",
                       os.path.join(ROOT, sub)])
    assert e.value.code == 2
    assert "refusing" in capsys.readouterr().err
    assert sorted(os.listdir(os.path.join(ROOT, "artifacts"))) == before


def test_empty_sweep_writes_no_summary(tmp_path, capsys):
    """No run under the sweep dir: no summary is written (as the JAX
    script, never an empty one), then the first export finds no curve."""
    os.makedirs(tmp_path / "empty")
    out = tmp_path / "out"
    assert exporter.summarize(str(tmp_path / "empty")) == {}
    with pytest.raises(FileNotFoundError):
        exporter.main([str(tmp_path / "empty"), "--out-dir", str(out)])
    assert "not written" in capsys.readouterr().out
    assert os.listdir(out) == []
