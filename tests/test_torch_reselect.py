"""`python -m acas2d_tpu_torch.population_reselect` (JAX
`scripts/population_reselect.py`) on a tiny population run on the CPU: it
rewrites the run's selection from its persisted snapshots, and at the
run's own re-eval episodes it selects what the run selected."""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch

from acas2d_tpu_torch import population_reselect, train

REVAL = 4
ARGV = ["--preset", "tpu", "--device", "cpu", "--population", "2",
        "--n-envs", "64", "--n-steps", "16", "--minibatch-size", "512",
        "--n-epochs", "2", "--eval-episodes", "3", "--eval-every", "1024",
        "--reval-episodes", str(REVAL), "--total-steps", str(2 * 64 * 16),
        "--fused-rollout", "--fused-update-packed", "--run-name", "pop"]
SELECTION_KEYS = ("selected_member", "selected_at_step", "selected_reval",
                  "selected_reval_std", "selected_score", "reval_evals",
                  "top_snapshots", "best_evals", "reval_episodes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def finished_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    with contextlib.redirect_stderr(io.StringIO()):
        train.run(train.parse_args(ARGV + ["--out-dir", str(out)]))
    return out / "pop"


@pytest.fixture
def run_copy(finished_run, tmp_path):
    return shutil.copytree(finished_run, tmp_path / "pop")


def _reselect(run, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert population_reselect.main(["--run", str(run), "--device",
                                         "cpu", *argv]) == 0
    return json.loads(out.getvalue())


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_reselect_at_the_run_episodes_selects_what_the_run_did(run_copy):
    with open(run_copy / "population.json") as f:
        before = json.load(f)
    params = _npz(run_copy / "selected_best.npz")
    (run_copy / "selected_best.npz").unlink()
    summary = _reselect(run_copy, "--episodes", str(REVAL))
    with open(run_copy / "population.json") as f:
        assert json.load(f) == summary              # rewritten
    assert summary["selected_by"] == "final_reval"
    assert int(np.isfinite(np.array(before["best_evals"], float)).sum()) == 2
    for key in SELECTION_KEYS:
        assert summary[key] == before[key], key
    # the training evals are not the archive's: a re-selection has none
    assert summary["final_evals"] == [None, None]
    again = _npz(run_copy / "selected_best.npz")
    assert again.keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(again[k], params[k])


def test_reselect_with_more_episodes_rewrites_the_selection(run_copy):
    summary = _reselect(run_copy, "--episodes", "6")
    assert summary["reval_episodes"] == 6
    with open(run_copy / "population.json") as f:
        assert json.load(f)["reval_episodes"] == 6
    assert (run_copy / "selected_best.npz").exists()


def test_reselect_needs_the_snapshot_archive(run_copy):
    (run_copy / "population_best.npz").unlink()
    with pytest.raises(SystemExit, match="no persisted member snapshots"):
        population_reselect.main(["--run", str(run_copy), "--device", "cpu"])


def test_reselect_defaults_to_cuda(run_copy):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        population_reselect.main(["--run", str(run_copy)])
