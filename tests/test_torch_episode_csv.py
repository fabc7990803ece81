"""The port's episode CSV (`acas2d_tpu_torch/utils/episode_csv.py`, no
pandas) and `python -m acas2d_tpu_torch.eval --out`, against the JAX
package.

  * The writer gives the bytes of the JAX package's
    `to_dataframe(episodes, columns).to_csv(index=False)` on the same
    records: telemetry records of real episodes, and records with the
    values a float column can hold (NaN, infinities, signed zeros, large
    and small exponents, integral floats), in both column layouts.
  * `eval --params-npz <flagship> --exact --episodes 5 --out` against the
    JAX driver `eval.py` with the same arguments (a subprocess: it updates
    `jax_platforms`), row by row.  Outcome and Time Steps are equal and the
    Traffic Paths within 1e-9 px.  The policy's own path is not: both
    drivers run the policy in float32, and the two MLPs round differently
    (test_torch_greedy.py), so an ulp of action moves the path by ~3e-5 px
    and the return by ~3e-5 over an episode (measured on these episodes);
    they are held within POLICY_ROUNDING.
  * The same port CSV against the JAX package's telemetry replaying the
    port's own actions (the CSV's `a_lat` record over the acceleration
    limit) from the same spawns, through the JAX `episode_records`: every
    record within 1e-9 (px, rewards and the rest), Total Reward within
    1e-8, Outcome and Time Steps exact.  This holds the port's eval path,
    from the spawns to the bytes, to the reference with the policy's
    rounding taken out.
"""

import ast
import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acas2d_tpu.config import DEFAULT_PARAMS as JP
from acas2d_tpu.envs import core as jcore
from acas2d_tpu.envs import telemetry as jtelemetry

from acas2d_tpu_torch import eval as teval
from acas2d_tpu_torch.config import DEFAULT_PARAMS, OUTCOME_NAMES
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.utils import episode_csv

pd = pytest.importorskip("pandas")
from acas2d_tpu.utils import episode_csv as jcsv  # noqa: E402  (pandas)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.npz")
N = 5
ATOL = 1e-9
POLICY_ROUNDING = 1e-3     # px and reward: float32 MLPs of two libraries
RECORD_LISTS = ["psi", "d_sep", "a_lat", "d_goal", "delta_heading",
                "v_closing", "d_cpa", "d_dev", "r_d_goal", "r_h_goal",
                "r_d_cpa", "r_d_dev", "r_step"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _real_records(n=3):
    """Telemetry records of n flagship episodes (float32 env, short)."""
    flat = teval.load_params(teval.parse_args(
        ["--params-npz", FLAGSHIP, "--device", "cpu"]))
    sp = MersenneSpawner(DEFAULT_PARAMS, skip_episodes=2)
    es, obs = learner.mersenne_reset(DEFAULT_PARAMS, sp, n, torch.float32,
                                     "cpu")
    return teval.telemetry_episodes(flat, es, obs)


def _edge_records():
    """Records whose float columns hold every kind of float64 text."""
    base = _real_records(1)[0]
    values = [float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e16,
              1.5e16, 9999999999999998.0, 1e-4, 1e-5, 0.1 + 0.2, 1200.0,
              -1e-300, 5e-324, 1.7976931348623157e308, 123456789.125]
    recs = []
    for i, v in enumerate(values):
        r = dict(base)
        r["Total Reward"] = v
        r["Path Length"] = values[-1 - i]
        r["Time Steps"] = i + 1
        r["psi"] = [v, 1.0]
        r["Outcome"] = ("Goal", "Collision", "Timeout")[i % 3]
        recs.append(r)
    return recs


@pytest.mark.parametrize("columns", ["full", "baseline"])
@pytest.mark.parametrize("kind", ["real", "edge"])
def test_writer_is_byte_identical_to_pandas(columns, kind, tmp_path):
    cols = (episode_csv.FULL_COLUMNS if columns == "full"
            else episode_csv.BASELINE_COLUMNS)
    assert cols == (jcsv.FULL_COLUMNS if columns == "full"
                    else jcsv.BASELINE_COLUMNS)
    episodes = _real_records() if kind == "real" else _edge_records()
    want = str(tmp_path / "want.csv")
    jcsv.to_dataframe(episodes, cols).to_csv(want, index=False)
    got = str(tmp_path / "got.csv")
    episode_csv.write_csv(got, episodes, cols)
    with open(want, "rb") as f, open(got, "rb") as g:
        assert g.read() == f.read()


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _pairs(text):
    return np.array(ast.literal_eval(text), dtype=np.float64)


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """The port's and the JAX driver's CSVs of the flagship's first N
    exact episodes, the two drivers run side by side."""
    out = tmp_path_factory.mktemp("csv")
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    args = ["--params-npz", FLAGSHIP, "--exact", "--episodes", str(N)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "acas2d_tpu_torch.eval", *args, "--out",
         str(out / "port.csv"), "--device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
        [sys.executable, "eval.py", *args, "--out", str(out / "jax.csv")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    summary = json.loads(outs[0][0].strip().splitlines()[-1])
    return _read(out / "port.csv"), _read(out / "jax.csv"), summary


def test_eval_csv_matches_the_jax_driver(csvs):
    port, jax_rows, summary = csvs
    assert len(port) == len(jax_rows) == N
    assert list(port[0]) == episode_csv.FULL_COLUMNS
    for p, j in zip(port, jax_rows):
        assert p["Episode"] == j["Episode"]
        assert p["Outcome"] == j["Outcome"]
        assert p["Time Steps"] == j["Time Steps"]
        tp, tj = ast.literal_eval(p["Traffic Paths"]), ast.literal_eval(
            j["Traffic Paths"])
        assert len(tp) == len(tj)
        for a, b in zip(tp, tj):
            np.testing.assert_allclose(np.array(a), np.array(b), atol=ATOL,
                                       rtol=0)
        pp, pj = _pairs(p["Path"]), _pairs(j["Path"])
        assert pp.shape == pj.shape
        np.testing.assert_allclose(pp, pj, atol=POLICY_ROUNDING, rtol=0)
        assert abs(float(p["Total Reward"]) - float(j["Total Reward"])
                   ) < POLICY_ROUNDING
    # the summary is the CSV's, episode for episode, to the sum's order
    rewards = [float(p["Total Reward"]) for p in port]
    assert summary["episodes"] == N
    assert summary["goals"] == sum(p["Outcome"] == "Goal" for p in port)
    assert abs(summary["mean_reward"] - np.mean(rewards)) < 1e-9


def test_eval_csv_matches_jax_telemetry_on_the_same_actions(csvs):
    port, _, _ = csvs
    sp = MersenneSpawner(DEFAULT_PARAMS, skip_episodes=2)
    inits = sp.spawn_batch(N)
    spawns = [jnp.asarray(np.stack([getattr(i, k) for i in inits]))
              for k in ("player_psi", "traffic_x", "traffic_y", "traffic_v",
                        "traffic_psi", "num_traffic")]
    ks = [int(p["Time Steps"]) - 1 for p in port]
    actions = np.zeros((N, max(ks)))
    for b, p in enumerate(port):
        a_lat = ast.literal_eval(p["a_lat"])[1:]      # [0] is the seed entry
        assert len(a_lat) == ks[b]
        actions[b, :ks[b]] = np.array(a_lat) / JP.acc_lat_limit

    def one(psi, tx, ty, tv, tpsi, nt, acts):
        state, _ = jcore.reset_from(psi, tx, ty, tv, tpsi, nt, JP,
                                    jnp.float64)
        init = jtelemetry.initial_telemetry(state, JP)
        return init, jtelemetry.rollout_telemetry(state, acts, JP)[1]

    init, tel = jax.device_get(jax.jit(jax.vmap(one))(
        *spawns, jnp.asarray(actions)))
    for b, p in enumerate(port):
        tel_b = jax.tree.map(lambda x: np.asarray(x[b]), tel)
        want = jcsv.episode_records({k: v[b] for k, v in init.items()},
                                    tel_b, ks[b], int(inits[b].num_traffic))
        assert p["Outcome"] == want["Outcome"]
        assert int(p["Time Steps"]) == want["Time Steps"]
        assert abs(float(p["Total Reward"]) - want["Total Reward"]) < 1e-8
        assert abs(float(p["Path Length"]) - want["Path Length"]) < ATOL
        np.testing.assert_allclose(_pairs(p["Path"]),
                                   np.array(want["Path"]), atol=ATOL, rtol=0)
        for a, w in zip(ast.literal_eval(p["Traffic Paths"]),
                        want["Traffic Paths"]):
            np.testing.assert_allclose(np.array(a), np.array(w), atol=ATOL,
                                       rtol=0)
        for name in RECORD_LISTS:
            np.testing.assert_allclose(np.array(ast.literal_eval(p[name])),
                                       np.array(want[name]), atol=ATOL,
                                       rtol=0, err_msg=name)


def test_float32_eval_writes_the_csv_of_its_episodes(tmp_path):
    """Without --exact the env steps in float32: the summary is the CSV's
    episodes, and the in-training greedy eval (`learner.GreedyEval`) of the
    same spawns plays the same episodes."""
    out = tmp_path / "eval_3.csv"
    res = teval.run(teval.parse_args(
        ["--params-npz", FLAGSHIP, "--episodes", "3", "--out", str(out),
         "--device", "cpu"]))
    rows = _read(out)
    assert res["dtype"] == "float32" and len(rows) == 3
    assert res["goals"] == sum(r["Outcome"] == "Goal" for r in rows)
    assert res["mean_length"] == np.mean([int(r["Time Steps"]) - 1
                                          for r in rows])
    assert res["mean_reward"] == np.mean([float(r["Total Reward"])
                                          for r in rows])
    flat = teval.load_params(teval.parse_args(
        ["--params-npz", FLAGSHIP, "--device", "cpu"]))
    ep = learner.exact_episodes(
        flat, DEFAULT_PARAMS, MersenneSpawner(DEFAULT_PARAMS,
                                              skip_episodes=2),
        3, torch.float32, "cpu")
    assert [OUTCOME_NAMES[int(o)] for o in ep["outcome"]] == [
        r["Outcome"] for r in rows]
    assert ep["length"].tolist() == [int(r["Time Steps"]) - 1 for r in rows]
    # two float32 sums of the same rewards in another order: within twice
    # the k-term bound, k = max_steps
    np.testing.assert_allclose(
        float(ep["return"].mean()), res["mean_reward"],
        rtol=2 * DEFAULT_PARAMS.max_steps * np.finfo(np.float32).eps, atol=0)
