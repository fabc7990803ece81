"""`python -m acas2d_tpu_torch.baseline` against the JAX `baseline.py` on the
CPU (both in float64: the tests run JAX with x64), and the pandas-free
CSV reader (`utils/episode_csv.read_csv`) that the render and analysis
paths read the CSVs with."""

import contextlib
import io
import math

import numpy as np
import pandas as pd
import pytest
import torch

import baseline as jax_baseline
import chip_smoke
from acas2d_tpu_torch import baseline
from acas2d_tpu_torch.utils import episode_csv

ACTIONS = "artifacts/gym_main_actions.npy"
PX_ATOL = 1e-9               # tests/test_drivers.py:24-41's tolerances
REWARD_ATOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    """(exit code, stdout) of a driver's main."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _both(tmp_path, argv):
    """The port's and JAX's CSV rows and stdout for the same arguments."""
    got, want = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    rc, got_out = _run(baseline.main, argv + ["--out", got, "--device", "cpu"])
    assert rc == 0
    rc, want_out = _run(jax_baseline.main, argv + ["--out", want])
    assert rc == 0
    with open(got) as f, open(want) as g:
        assert f.readline() == g.readline()           # the same columns
    return (episode_csv.read_csv(got), episode_csv.read_csv(want),
            got_out, want_out)


@pytest.mark.parametrize("policy", ["zero", "mod3", "cosine", "replay"])
def test_baseline_matches_jax(tmp_path, policy):
    """4 episodes of each scripted policy: outcomes and time steps exact,
    paths within 1e-9 px, total rewards within 1e-8, and the same
    per-episode lines (their returns to the last digits apart)."""
    argv = ["--episodes", "4", "--policy", policy]
    if policy == "replay":
        argv += ["--actions-file", ACTIONS]
    got, want, got_out, want_out = _both(tmp_path, argv)
    assert len(got) == 4
    _, px_err, r_err = chip_smoke.compare_baselines(got, want)
    assert px_err <= PX_ATOL and r_err <= REWARD_ATOL
    lines = [ln.split("Total Reward")[0] for ln in got_out.splitlines()]
    assert lines == [ln.split("Total Reward")[0]
                     for ln in want_out.splitlines()]


def test_full_telemetry_matches_jax(tmp_path):
    """--full-telemetry's columns: every record list within 1e-9 of
    JAX's."""
    got, want, _, _ = _both(tmp_path, ["--episodes", "2", "--policy", "mod3",
                                       "--full-telemetry"])
    assert list(got[0]) == episode_csv.FULL_COLUMNS
    for g, w in zip(got, want):
        for col in episode_csv.FULL_COLUMNS:
            if isinstance(w[col], str):
                assert g[col] == w[col]
            else:
                np.testing.assert_allclose(np.asarray(g[col]),
                                           np.asarray(w[col]),
                                           atol=PX_ATOL, rtol=0)


def test_fast_mode_steps_in_float32(tmp_path):
    """--fast plays the same spawns in float32: its paths are float32
    values, and its outcomes those of the float64 run here."""
    out32, out64 = str(tmp_path / "f32.csv"), str(tmp_path / "f64.csv")
    for flag, out in (("--fast", out32), ("--exact", out64)):
        rc, _ = _run(baseline.main, ["--episodes", "3", flag, "--out", out,
                                     "--device", "cpu"])
        assert rc == 0
    f32, f64 = episode_csv.read_csv(out32), episode_csv.read_csv(out64)
    assert [r["Outcome"] for r in f32] == [r["Outcome"] for r in f64]
    path = np.asarray(f32[0]["Path"])
    np.testing.assert_array_equal(path, path.astype(np.float32))


def test_baseline_needs_a_device_or_cpu(tmp_path):
    """The driver defaults to CUDA and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        baseline.main(["--episodes", "1", "--out", str(tmp_path / "b.csv")])


def test_read_csv_inverts_write_csv(tmp_path):
    """Integers, floats (NaN as an empty cell), names and list columns come
    back as written, and as pandas reads the same file."""
    episodes = [{"Outcome": "Goal", "Total Reward": 1.5, "Time Steps": 7,
                 "Path": [(1.0, 2.25), (3.0, -4.125)],
                 "Traffic Paths": [[(5.0, 6.0)], [(7.5, 8.0)]]},
                {"Outcome": "Timeout", "Total Reward": float("nan"),
                 "Time Steps": 1001, "Path": [(0.1, 0.2)],
                 "Traffic Paths": []}]
    path = str(tmp_path / "e.csv")
    episode_csv.write_csv(path, episodes, episode_csv.BASELINE_COLUMNS)
    rows = episode_csv.read_csv(path)
    assert [r["Episode"] for r in rows] == [1, 2]
    for row, ep in zip(rows, episodes):
        for col, value in ep.items():
            if isinstance(value, float) and math.isnan(value):
                assert math.isnan(row[col])
            else:
                assert row[col] == value and type(row[col]) is type(value)
    df = pd.read_csv(path)
    assert list(df.columns) == list(rows[0])
    assert df["Time Steps"].tolist() == [r["Time Steps"] for r in rows]
    assert df["Total Reward"][0] == rows[0]["Total Reward"]


@pytest.mark.slow
def test_baseline_100_episodes_against_jax(tmp_path):
    """The reference's 100 zero-action episodes against JAX's: outcomes
    and steps on all 100, paths within 1e-9 px; and the count of paths
    bit-identical with JAX's (README.md:27's scale)."""
    got, want, _, _ = _both(tmp_path, ["--episodes", "100"])
    same, px_err, r_err = chip_smoke.compare_baselines(got, want)
    assert px_err <= PX_ATOL and r_err <= REWARD_ATOL
    assert same >= 90, f"only {same}/100 paths bit-identical with JAX's"
