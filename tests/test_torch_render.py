"""Rendering, the eval driver's render flags and the analysis driver of the
port (`acas2d_tpu_torch/{render,eval,analysis}.py`) against the JAX
package's `render.py` and `analysis.py`, on the CPU: frames pixel for
pixel, HUD strings character for character, the reward curves as numbers.
They draw with matplotlib, which the card's machine lacks: every test
here skips without it."""

import contextlib
import io
import itertools
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

pytest.importorskip("matplotlib")
import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.image as mpimg  # noqa: E402

import analysis as jax_analysis  # noqa: E402
from acas2d_tpu import render as jax_render  # noqa: E402
from acas2d_tpu.config import EnvParams as JEnvParams  # noqa: E402
from acas2d_tpu.ops import rewards as JR  # noqa: E402
from acas2d_tpu_torch import analysis, baseline, render  # noqa: E402
from acas2d_tpu_torch import eval as teval  # noqa: E402
from acas2d_tpu_torch.config import DEFAULT_PARAMS  # noqa: E402
from acas2d_tpu_torch.oracle import MersenneSpawner, OracleEnv  # noqa: E402

P = DEFAULT_PARAMS
NPZ = "artifacts/ppo_ref_s8_best.npz"
CURVE_ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replayed_states(every=150):
    """Scalar states of the recorded action trace through the port's
    oracle (the spawn at the reference's offset), one every `every`
    steps, with the running total reward."""
    seq = np.load("artifacts/gym_main_actions.npy")
    env = OracleEnv(P, spawner=MersenneSpawner(P, skip_episodes=2))
    env.reset()
    states = []
    for t, a in enumerate(seq):
        _, _, done, _ = env.step(np.array([a]))
        s = env.state
        if t % every == 0 or done:
            states.append(dict(
                px=s.px, py=s.py, psi=s.ppsi, tx=s.tx.copy(), ty=s.ty.copy(),
                tv=s.tv.copy(), tpsi=s.tpsi.copy(), a_lat=s.pa_lat,
                steps=s.steps, episode=3, total_reward=s.total_reward,
                num_traffic=s.num_traffic))
        if done:
            break
    return states


def test_hud_strings_equal_jax():
    for s in _replayed_states():
        kw = {k: v for k, v in s.items() if k != "num_traffic"}
        got = render.hud_quantities(**kw, params=P)
        assert got == jax_render.hud_quantities(**kw, params=JEnvParams())
        assert len(got) == 21


@pytest.mark.parametrize("hud", [False, True], ids=["bare", "hud"])
def test_frames_equal_jax_pixel_for_pixel(hud):
    trail = []
    for s in _replayed_states(300):
        trail.append((s["px"], s["py"]))
        args = (s["px"], s["py"], s["psi"], s["tx"], s["ty"],
                s["num_traffic"])
        kw = dict(trail=list(trail))
        if hud:
            kw.update(tv=s["tv"], tpsi=s["tpsi"], a_lat=s["a_lat"],
                      steps=s["steps"], episode=s["episode"],
                      total_reward=s["total_reward"])
        got = render.render_frame(*args, P, **kw)
        want = jax_render.render_frame(*args, JEnvParams(), **kw)
        assert got.shape == (500, 800, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def sprite_dir(tmp_path, monkeypatch):
    """A reference layout with three made-up sprites; both packages' sprite
    caches are reloaded after."""
    png = tmp_path / "gym_ACAS2D" / "png"
    png.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for name in ("001-plane.png", "002-travelling.png", "003-army.png"):
        img = np.concatenate([rng.uniform(size=(24, 24, 3)),
                              np.ones((24, 24, 1))], axis=-1)
        mpimg.imsave(str(png / name), img)
    monkeypatch.setenv("ACAS2D_REFERENCE_DIR", str(tmp_path))
    yield tmp_path
    monkeypatch.delenv("ACAS2D_REFERENCE_DIR")
    render.load_sprites(refresh=True)
    jax_render.load_sprites(refresh=True)


def test_sprite_composition_and_the_no_asset_path(sprite_dir, tmp_path,
                                                  monkeypatch):
    """tests/test_drivers.py:122-146 on the port: with the reference's png/
    layout the frame composites the sprites, pixel for pixel JAX's;
    without it (an empty directory) the markers are drawn instead."""
    args = (200.0, 500.0, 0.0, np.array([1552.0]), np.array([48.0]), 1)
    assert render.load_sprites(refresh=True) is not None
    assert jax_render.load_sprites(refresh=True) is not None
    with_sprites = render.render_frame(*args, P)
    np.testing.assert_array_equal(with_sprites,
                                  jax_render.render_frame(*args, JEnvParams()))

    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("ACAS2D_REFERENCE_DIR", str(empty))
    assert render.load_sprites(refresh=True) is None
    fallback = render.render_frame(*args, P)
    assert with_sprites.shape == fallback.shape
    diff = np.abs(with_sprites.astype(int) - fallback.astype(int)).sum(-1)
    assert (diff > 0).sum() > 100


def _baseline_csv(path, episodes=3):
    with contextlib.redirect_stdout(io.StringIO()):
        assert baseline.main(["--episodes", str(episodes), "--policy", "mod3",
                              "--out", path, "--device", "cpu"]) == 0
    return path


def test_episode_replays_from_a_csv_equal_jax(tmp_path):
    """render_run_csv reads the CSV without pandas and draws JAX's plots."""
    csv = _baseline_csv(str(tmp_path / "b.csv"), 2)
    got = render.render_run_csv(csv, str(tmp_path / "port"))
    want = jax_render.render_run_csv(csv, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == ["episode_001.png",
                                                  "episode_002.png"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(mpimg.imread(g), mpimg.imread(w))


def _eval(argv, tmp_path):
    return teval.main(["--params-npz", NPZ, "--device", "cpu",
                       "--out", str(tmp_path / "e.csv")] + argv)


def test_eval_writes_render_frames(tmp_path):
    """tests/test_drivers.py:264-281 on the port: --render-every dumps
    full-HUD frames of the chosen episodes, first and last step among
    them, from the records of the episodes played."""
    fdir = tmp_path / "frames"
    assert _eval(["--episodes", "2", "--render-every", "400",
                  "--render-episodes", "1,2", "--render-dir", str(fdir)],
                 tmp_path) == 0
    rows = teval.episode_csv.read_csv(str(tmp_path / "e.csv"))
    for e in (1, 2):
        pngs = sorted(os.listdir(fdir / f"episode_{e:03d}"))
        last = rows[e - 1]["Time Steps"] - 2          # the done step's t
        assert pngs[0] == "step_0000.png"
        assert pngs[-1] == f"step_{last:04d}.png"
        assert len(pngs) == 2 + (last > 400)


def test_eval_view_shares_the_render_frame_source(tmp_path, monkeypatch,
                                                  request):
    """tests/test_drivers.py:284-330 on the port: --view replays through
    the same frame source as --render-every (`episode_frames`), pixel for
    pixel.  Each episode's frames are cut to its first four, which both
    paths then draw."""
    calls = []
    real = teval.episode_frames

    def first_frames(*args):
        calls.append(args[-2:])                      # (every, episode)
        return itertools.islice(real(*args), 4)

    monkeypatch.setattr(teval, "episode_frames", first_frames)
    live = []
    real_view = teval.view_episodes

    def spy_view(iters, fps=100.0, caption="ACAS-2D"):
        shown = [(e, list(frames)) for e, frames in iters]
        live.extend(f for _, frames in shown for _, f in frames)
        return real_view(((e, iter(fr)) for e, fr in shown), fps=fps,
                         caption=caption)

    monkeypatch.setattr(teval, "view_episodes", spy_view)
    import matplotlib.pyplot as plt
    request.addfinalizer(plt.ioff)          # the view turns interactive on
    assert _eval(["--episodes", "1", "--view", "--view-fps", "100000"],
                 tmp_path) == 0
    fdir = tmp_path / "frames"
    assert _eval(["--episodes", "1", "--render-every", "1",
                  "--render-dir", str(fdir)], tmp_path) == 0
    assert calls == [(1, 1), (1, 1)] and len(live) == 4
    for t, frame in enumerate(live):
        png = mpimg.imread(str(fdir / "episode_001" / f"step_{t:04d}.png"))
        np.testing.assert_array_equal(
            np.round(png[..., :3] * 255).astype(np.uint8), frame)


@pytest.mark.parametrize("argv,message", [
    (["--render-every", "10", "--render-episodes", "1,3"], "out of range"),
    (["--view", "--render-episodes", "one"], "comma-separated"),
    (["--render-every", "10"], "matplotlib"),
])
def test_render_flags_fail_before_anything_is_played(tmp_path, monkeypatch,
                                                     capsys, argv, message):
    """A bad --render-episodes, or a render flag without matplotlib, exits
    2 before any episode is played or the CSV written."""
    if message == "matplotlib":
        monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)

    def never(*args):
        raise AssertionError("an episode was played")

    monkeypatch.setattr(teval, "play", never)
    assert _eval(["--episodes", "2"] + argv, tmp_path) == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "e.csv").exists()


def test_reward_curves_equal_jax_ops():
    """The curves of the reward-shape plot, from the port's ops in float64,
    within 1e-12 of JAX's `ops/rewards` on the same grid (x64)."""
    c = analysis.reward_shape_curves(P, device="cpu")
    p = JEnvParams()
    j = {
        "heading": JR.heading_reward(c["heading"][0], 0.0),
        "closest_approach_closing": JR.closest_approach_reward(
            np.full_like(c["closest_approach_closing"][0], -1.0),
            c["closest_approach_closing"][0], p.safe_distance),
        "closest_approach_separating": JR.closest_approach_reward(
            np.full_like(c["closest_approach_separating"][0], 1.0),
            c["closest_approach_separating"][0], p.safe_distance),
        "plan_deviation": JR.plan_deviation_reward(
            c["plan_deviation"][0], p.d_dev_max_reward),
        "goal_distance": JR.goal_distance_reward(
            c["goal_distance"][0], p.d_goal_max_reward),
        "polarized_plus_50": JR.polarized_plan_deviation_reward(
            c["polarized_plus_50"][0],
            np.full_like(c["polarized_plus_50"][0], 50.0), p.d_dev_max_reward),
        "polarized_minus_50": JR.polarized_plan_deviation_reward(
            c["polarized_minus_50"][0],
            np.full_like(c["polarized_minus_50"][0], -50.0),
            p.d_dev_max_reward),
        "time_discount": 1.0 - c["time_discount"][0] / p.max_steps,
    }
    assert set(c) == set(j)
    for name, (x, y) in c.items():
        assert y.dtype == np.float64 and y.shape == x.shape
        np.testing.assert_allclose(y, np.asarray(j[name]), atol=CURVE_ATOL,
                                   rtol=0, err_msg=name)


def test_analysis_driver_matches_jax(tmp_path):
    """`analysis.main`'s summary equals JAX's outcome_summary of the same CSV
    (pandas), its trajectory plot is JAX's pixel for pixel, and it writes
    the replays, the learning curve and the reward shapes."""
    csv = _baseline_csv(str(tmp_path / "b.csv"))
    lc = tmp_path / "eval.csv"
    lc.write_text("global_step,eval_return_mean\n1024,12.5\n2048,40.25\n")
    out = tmp_path / "analysis"
    with contextlib.redirect_stdout(io.StringIO()):
        assert analysis.main(["--csv", csv, "--episodes", "2",
                              "--learning-curve", str(lc), "--reward-shapes",
                              "--out-dir", str(out), "--device", "cpu"]) == 0
    df = pd.read_csv(csv)
    with open(out / "summary.json") as f:
        assert json.load(f) == jax_analysis.outcome_summary(df)
    jax_png = jax_analysis.trajectory_overview(df, JEnvParams(),
                                               str(tmp_path / "j.png"))
    np.testing.assert_array_equal(mpimg.imread(str(out / "trajectories.png")),
                                  mpimg.imread(jax_png))
    for name in ("episode_002.png", "learning_curve.png",
                 "reward_shapes.png"):
        assert os.path.getsize(out / name) > 1000, name
