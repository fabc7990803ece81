"""The port's scalar oracle, gym adapters, env checker and manual play
(`acas2d_tpu_torch/{oracle,manual}.py`, `envs/gym_compat.py`,
`utils/env_check.py`) against the JAX package on the same seeds, on the
CPU.

gymnasium's registry is one per process, and a test file of the JAX
package (`tests/test_drivers.py::test_gymnasium_env_api`) may run later
in the same worker: every test here that registers the port's
'ACAS2D-v0' does so inside `port_registration`, which puts the earlier
entry back.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from acas2d_tpu import oracle as joracle
from acas2d_tpu.config import EnvParams as JEnvParams
from acas2d_tpu_torch import oracle
from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams

import chip_smoke

P = DEFAULT_PARAMS
OBS_ATOL = 1e-12               # tests/test_drivers.py:70-88's tolerances
REWARD_ATOL = 1e-9
ENV_ID = "ACAS2D-v0"
PORT_ENTRY = "acas2d_tpu_torch.envs.gym_compat:ACAS2DEnv"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers side by side,
    and these loops of small ops slow down many-fold when the workers'
    threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def registry_kept():
    """gymnasium's 'ACAS2D-v0' entry after as it was before (absent, or
    another's)."""
    try:
        from gymnasium.envs.registration import registry
    except ImportError:
        yield
        return
    saved = registry.get(ENV_ID)
    try:
        yield
    finally:
        if saved is None:
            registry.pop(ENV_ID, None)
        else:
            registry[ENV_ID] = saved


@pytest.fixture(autouse=True, scope="module")
def kept_registry():
    """The port's gym_compat registers its env when first imported: put
    the entry back after this file's tests.  The JAX package's gym_compat
    registers its own when first imported, and its test
    (tests/test_drivers.py) counts on that: import it before the entry is
    saved, so that a first import by this file is not undone after it."""
    import acas2d_tpu.envs.gym_compat  # noqa: F401
    with registry_kept():
        yield


@contextlib.contextmanager
def port_registration():
    """'ACAS2D-v0' registered to the port's env inside, and as it was
    before after."""
    gymnasium = pytest.importorskip("gymnasium")
    with registry_kept():
        from acas2d_tpu_torch.envs import gym_compat
        gym_compat.register_gymnasium()
        yield gymnasium


def _actions(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, size=n)


@pytest.mark.parametrize("bug_compat", [True, False])
def test_oracle_equals_the_jax_oracle_bit_for_bit(bug_compat):
    """Three episodes of random actions from the same Mersenne stream:
    every observation, reward, done flag, outcome, path and total reward
    identical."""
    ports = oracle.OracleEnv(EnvParams(bug_compat=bug_compat))
    jaxs = joracle.OracleEnv(JEnvParams(bug_compat=bug_compat))
    for episode in range(3):
        np.testing.assert_array_equal(ports.reset(), jaxs.reset())
        for a in _actions(episode, P.max_steps):
            got = ports.step(np.array([a]))
            want = jaxs.step(np.array([a]))
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
            if got[2]:
                break
        assert got[2]
        assert ports.state.outcome == jaxs.state.outcome
        assert ports.state.steps == jaxs.state.steps
        assert ports.state.total_reward == jaxs.state.total_reward
        assert ports.path == jaxs.path
        assert ports.traffic_paths == jaxs.traffic_paths


def test_oracle_episode_runner_equals_jax():
    """`run_episode` (the zero policy by default, and a policy) returns
    JAX's record."""
    for policy in (None, lambda obs, t: np.array([np.cos(t / 50.0)])):
        got = oracle.OracleEnv(P).run_episode(policy)
        want = joracle.OracleEnv(JEnvParams()).run_episode(policy)
        assert got == want


@pytest.mark.parametrize("action", [0.3, -0.7])
def test_legacy_env_matches_the_jax_oracle(action):
    """tests/test_drivers.py:70-88 on the port: the float64 legacy env on
    the CPU against JAX's OracleEnv from the same stream (episode 0)."""
    from acas2d_tpu_torch.envs.gym_compat import LegacyACAS2DEnv

    env = LegacyACAS2DEnv(P, device="cpu", dtype=torch.float64)
    o = joracle.OracleEnv(JEnvParams(),
                          spawner=joracle.MersenneSpawner(JEnvParams()))
    np.testing.assert_allclose(env.reset(), o.reset(), atol=OBS_ATOL, rtol=0)
    done, t = False, 0
    while not done and t < P.max_steps:
        obs_e, r_e, done, info = env.step(np.array([action]))
        obs_o, r_o, done_o, _ = o.step(np.array([action]))
        assert done == done_o
        np.testing.assert_allclose(obs_e, obs_o, atol=OBS_ATOL, rtol=0)
        assert abs(r_e - r_o) <= REWARD_ATOL
        t += 1
    assert done and env.outcome == o.state.outcome
    assert info == {}


def test_gym_replay_of_the_recorded_actions():
    """chip_smoke.py phase 18 (b) on the CPU: the recorded action trace
    through the float64 legacy env against the port's oracle, at
    tests/test_drivers.py:195-237's tolerances."""
    steps, _, px_err, r_err = chip_smoke.gym_replay("cpu")
    assert steps > 1
    assert px_err <= 1e-9 and r_err <= 1e-12


def test_gymnasium_make_gives_the_port_env():
    with port_registration() as gymnasium:
        env = gymnasium.make(ENV_ID, device="cpu")
        assert type(env.unwrapped).__module__ == "acas2d_tpu_torch.envs.gym_compat"
        obs, info = env.reset(seed=13)
        assert env.observation_space.contains(obs) and info == {}
        for _ in range(P.max_steps):
            obs, r, term, trunc, info = env.step(np.array([0.0]))
            if term or trunc:
                break
        assert term or trunc
        assert info["outcome"] in (1, 2, 3)


def test_gymnasium_env_matches_jax_and_renders_the_same_frame():
    """The 5-tuple env in float64 against JAX's (x64 in the tests) from a
    seeded reset: observations within 1e-12, rewards within 1e-9, the same
    terminated / truncated / outcome; then its rgb_array frame, pixel for
    pixel JAX's."""
    pytest.importorskip("gymnasium")
    from acas2d_tpu.envs.gym_compat import ACAS2DEnv as JaxEnv
    from acas2d_tpu_torch.envs.gym_compat import ACAS2DEnv

    mode = "rgb_array"
    env = ACAS2DEnv(P, render_mode=mode, device="cpu", dtype=torch.float64)
    ref = JaxEnv(JEnvParams(), render_mode=mode)
    got, want = env.reset(seed=5), ref.reset(seed=5)
    np.testing.assert_allclose(got[0], want[0], atol=OBS_ATOL, rtol=0)
    for a in _actions(5, 60):
        got = env.step(np.array([a]))
        want = ref.step(np.array([a]))
        np.testing.assert_allclose(got[0], want[0], atol=OBS_ATOL, rtol=0)
        assert abs(got[1] - want[1]) <= REWARD_ATOL
        assert got[2:] == want[2:]
    pytest.importorskip("matplotlib")
    np.testing.assert_array_equal(env.render(), ref.render())


def test_random_spawns_are_seeded():
    """exact_spawn=False draws from the backend's generator: one seed, one
    episode sequence."""
    from acas2d_tpu_torch.envs.gym_compat import LegacyACAS2DEnv

    envs = [LegacyACAS2DEnv(P, exact_spawn=False, device="cpu")
            for _ in range(2)]
    for env in envs:
        env.seed(21)
    first = [env.reset() for env in envs]
    np.testing.assert_array_equal(*first)
    np.testing.assert_array_equal(envs[0].reset(), envs[1].reset())
    assert envs[0].observation_space.contains(first[0])


def test_legacy_env_spaces_without_gymnasium(monkeypatch):
    """tests/test_utils.py:103-115 on the port: the plain Box stand-in."""
    from acas2d_tpu_torch.envs import gym_compat

    monkeypatch.setattr(gym_compat, "_HAS_GYMNASIUM", False)
    env = gym_compat.LegacyACAS2DEnv(device="cpu")
    assert isinstance(env.observation_space, gym_compat._PlainBox)
    obs = env.reset()
    assert env.observation_space.shape == (8,)
    assert env.action_space.shape == (1,)
    assert env.observation_space.contains(obs)
    assert env.action_space.contains(np.array([0.5]))
    assert not env.action_space.contains(np.array([1.5]))


def test_the_registry_entry_is_put_back():
    """After the port's registration the spec of 'ACAS2D-v0' is the one
    from before, here the JAX package's, which its own test then makes."""
    gymnasium = pytest.importorskip("gymnasium")
    jax_entry = "acas2d_tpu.envs.gym_compat:ACAS2DEnv"
    with registry_kept():
        import acas2d_tpu.envs.gym_compat  # noqa: F401
        gymnasium.register(id=ENV_ID, entry_point=jax_entry)  # as its import
        with port_registration():
            assert gymnasium.spec(ENV_ID).entry_point == PORT_ENTRY
        assert gymnasium.spec(ENV_ID).entry_point == jax_entry
        env = gymnasium.make(ENV_ID)
        assert type(env.unwrapped).__module__ == "acas2d_tpu.envs.gym_compat"


def test_gym_adapters_need_a_device():
    """The adapters default to CUDA and never fall back to the CPU."""
    from acas2d_tpu_torch.envs.gym_compat import LegacyACAS2DEnv
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LegacyACAS2DEnv(P)


def test_env_checks_pass():
    from acas2d_tpu_torch.envs.gym_compat import LegacyACAS2DEnv
    from acas2d_tpu_torch.utils.env_check import (check_functional_env,
                                                  check_gym_env)
    check_functional_env(P, n_random_steps=50, device="cpu")
    check_gym_env(LegacyACAS2DEnv(P, device="cpu"), n_random_steps=30)
    assert chip_smoke.env_checks("cpu").startswith("gymnasium")
    with port_registration() as gymnasium:
        check_gym_env(gymnasium.make(ENV_ID, device="cpu"),
                      n_random_steps=30)


@pytest.mark.parametrize("where", ["gym", "functional"])
def test_env_check_rejects_an_observation_out_of_its_box(where, monkeypatch):
    from acas2d_tpu_torch.envs import core, gym_compat
    from acas2d_tpu_torch.utils import env_check

    if where == "gym":
        class Broken(gym_compat.LegacyACAS2DEnv):
            def reset(self):
                return super().reset() + 5.0

        with pytest.raises(env_check.EnvCheckError, match="outside"):
            env_check.check_gym_env(Broken(P, device="cpu"),
                                    n_random_steps=3)
    else:
        real = core.step_autoreset

        def broken(*args, **kwargs):
            state, out = real(*args, **kwargs)
            return state, out.replace(obs=out.obs + 5.0)

        monkeypatch.setattr(core, "step_autoreset", broken)
        with pytest.raises(env_check.EnvCheckError, match="outside"):
            env_check.check_functional_env(P, n_random_steps=3,
                                           device="cpu")
    assert issubclass(env_check.EnvCheckError, AssertionError)


@pytest.mark.parametrize("flags", [["--frames", "frames"], ["--view"]],
                         ids=["frames", "view_without_a_display"])
def test_manual_play_from_a_scripted_stdin(tmp_path, monkeypatch, flags):
    """`manual.main` driven by keys on stdin (steer, straight, soft turns,
    reset, quit) into tmp_path: one frame a step, with --frames, or with
    --view, which falls back to --frames manual_frames/ without a
    display."""
    pytest.importorskip("matplotlib")
    from acas2d_tpu_torch import manual

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr("sys.stdin", io.StringIO("d\na\ns\nj\nl\nr\nd\nq\n"))
    out = io.StringIO()
    with port_registration(), contextlib.redirect_stdout(out):
        assert manual.main(flags + ["--device", "cpu"]) == 0
    text = out.getvalue()
    assert "-- reset --" in text and text.count(" > ") == 8   # 8 prompts
    frames_dir = tmp_path / ("frames" if "--frames" in flags
                             else "manual_frames")
    frames = sorted(os.listdir(frames_dir))
    assert frames == [f"f{t:05d}.png" for t in range(1, 6)]
    import matplotlib.image as mpimg
    frame = mpimg.imread(str(frames_dir / frames[-1]))
    assert frame.shape[:2] == (500, 800)


def test_telemetry_matches_the_oracle_records():
    """tests/test_drivers.py:44-67 on the port: the telemetry rollout's
    player path (after its update) and traffic path (before theirs) are
    the scalar oracle's."""
    from acas2d_tpu_torch.envs import core, telemetry

    o = oracle.OracleEnv(P, spawner=oracle.MersenneSpawner(
        P, skip_episodes=2))
    o.reset()
    i = oracle.MersenneSpawner(P, skip_episodes=2).spawn()
    state, _ = core.reset_from([i.player_psi], i.traffic_x[None],
                               i.traffic_y[None], i.traffic_v[None],
                               i.traffic_psi[None], [i.num_traffic], P,
                               torch.float64, "cpu")
    T = 100
    for _ in range(T):
        o.step(np.array([0.0]))
    _, tel = telemetry.rollout_telemetry(
        state, torch.zeros(T, 1, dtype=torch.float64), P)
    tel = tel.numpy().env(0)
    opath = np.array(o.path)               # includes the t=0 entry
    np.testing.assert_allclose(tel.px, opath[1:, 0], atol=1e-9, rtol=0)
    np.testing.assert_allclose(tel.py, opath[1:, 1], atol=1e-9, rtol=0)
    otp = np.array(o.traffic_paths[0])     # t=0 entry + pre-update records
    np.testing.assert_allclose(tel.tx[:, 0], otp[1:, 0], atol=1e-9, rtol=0)
