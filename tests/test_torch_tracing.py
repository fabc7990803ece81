"""The program's spans, counters and phase marks (`utils/profiling.py`,
`ppo/learner.phase_marks`, `ops/phase_mark.py`) on the CPU, one torch
thread: what is recorded and when, how spans nest and how many are kept,
the iteration's phases in order, the greedy eval's chunks and its early
exit, and a training call and an eval that give the same bits with
recording on and off.

Tests marked `cuda` skip without a card; on one, run them with

    python -m pytest --noconftest tests/test_torch_tracing.py -q

They check that a profiled replayed call carries the four marker kernels
of every iteration, in order, that recording changes no loss, and that
the unfused paths build the marks' library and no other.
"""

import contextlib
import dataclasses
import json
import os

import pytest
import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops import phase_mark
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.ppo.config import PPOConfig
from acas2d_tpu_torch.utils import profiling
from acas2d_tpu_torch.utils.params_io import load_flat_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "artifacts", "ppo_tpu_e_polished_best.npz")
TINY = dict(n_envs=64, n_steps=16, fused_chunk=8, minibatch_size=256,
            n_epochs=2, total_timesteps=64 * 16 * 8, fused_rollout=True,
            fused_update=True, anneal_lr=True, eval_episodes=3)
CPU = torch.profiler.ProfilerActivity.CPU
# episodes of at most 200 steps: four chunks (3 x 64 + 8), each op of them
# recorded by the CPU profiler
SHORT = dataclasses.replace(DEFAULT_PARAMS, max_steps=200)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cleared():
    profiling.clear()
    yield
    profiling.clear()


def _names(spans=None):
    return [s.name for s in (profiling.spans() if spans is None else spans)]


def test_records_only_while_a_profiler_records():
    """Nothing outside a session or in a schedule's warm-up step; the
    active step records spans and counters."""
    with profiling.span("outside"):
        profiling.count("n", 5)
    prof = torch.profiler.profile(
        activities=[CPU], on_trace_ready=lambda p: None,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
    prof.start()
    with profiling.span("warmup"):
        profiling.count("n", 7)
    prof.step()
    with profiling.span("active", call=3):
        profiling.count("n", 2)
        profiling.count("n")
    prof.step()
    prof.stop()
    with profiling.span("after"):
        profiling.count("n")
    (s,) = profiling.spans()
    assert (s.name, s.key, s.parent) == ("active", {"call": 3}, -1)
    assert s.start_ns <= s.end_ns
    assert profiling.counters() == {"n": 3}


def test_parents_nest():
    with torch.profiler.profile(activities=[CPU]):
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    by = {s.name: s for s in profiling.spans()}
    assert _names() == ["c", "b", "d", "a", "e"]        # kept as they end
    assert by["b"].parent == by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id
    assert by["a"].parent == by["e"].parent == -1
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].end_ns \
        <= by["b"].end_ns <= by["d"].start_ns <= by["a"].end_ns


def test_the_bound_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    rec = profiling.Recorder()
    with torch.profiler.profile(activities=[CPU]):
        for i in range(7):
            with rec.span(f"s{i}"):
                pass
    assert _names(rec.spans()) == ["s3", "s4", "s5", "s6"]
    assert rec.dropped() == 3
    rec.clear()
    assert rec.spans() == [] and rec.dropped() == 0


def _solo_state(cfg):
    return learner.init_train_state(cfg, DEFAULT_PARAMS, "cpu")


def _pop_state(cfg):
    return population.init_population(cfg, DEFAULT_PARAMS, 2, "cpu")


@pytest.mark.parametrize("pop", [False, True], ids=["solo", "p2"])
def test_eager_steps_give_the_phases_in_order(pop):
    """An eager step's host spans are `iteration.rollout`, `.gae` and
    `.update`, back to back in that order, and `on_phase` still hears each
    phase end."""
    cfg = PPOConfig(**TINY)
    heard = []
    step = (population.make_population_step(cfg, DEFAULT_PARAMS, "cpu",
                                            on_phase=heard.append)
            if pop else learner.make_train_step(cfg, DEFAULT_PARAMS, "cpu",
                                                on_phase=heard.append))
    state = _pop_state(cfg) if pop else _solo_state(cfg)
    with torch.profiler.profile(activities=[CPU]):
        for _ in range(2):
            state, _ = step(state)
    assert heard == list(learner.PHASES) * 2
    spans = profiling.spans()
    assert _names(spans) == [f"iteration.{p}" for p in learner.PHASES] * 2
    for a, b in zip(spans, spans[1:]):
        assert a.end_ns <= b.start_ns
    assert all(s.parent == -1 for s in spans)


def _circling():
    model = ActorCritic(generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.action_head.bias.fill_(1.0)          # a full turn, always
    return flatten(model)


@pytest.mark.parametrize("policy", ["flagship", "circling"])
def test_eval_chunks_are_counted_and_the_early_exit_cuts_them(policy):
    """One `eval.chunk` span a chunk, as many as `eval.chunks` counts,
    under the `eval` span with its reset and result: every chunk of
    max_steps for a policy that flies in circles until then (4 at 200
    steps: 3 of 64 and one of 8), fewer than the 16 of 1000 steps for the
    flagship, whose episodes end early."""
    flagship = policy == "flagship"
    params = load_flat_params(FLAGSHIP)[0] if flagship else _circling()
    cfg = PPOConfig(**TINY)
    eval_fn = learner.make_eval_fn(cfg, DEFAULT_PARAMS if flagship else SHORT,
                                   device="cpu")
    with torch.profiler.profile(activities=[CPU]):
        m = eval_fn(params, torch.Generator().manual_seed(11))
    spans = profiling.spans()
    chunks = [s for s in spans if s.name == "eval.chunk"]
    (ev,) = [s for s in spans if s.name == "eval"]
    assert ev.key == {"eval": 1}
    assert len(chunks) == profiling.counters()["eval.chunks"]
    assert all(s.parent == ev.id for s in spans if s is not ev)
    assert _names(spans) == (["eval.reset"] + ["eval.chunk"] * len(chunks)
                             + ["eval.result", "eval"])
    if flagship:
        assert 1 <= len(chunks) < 15
        assert float(m["eval_length_mean"]) <= 64 * len(chunks)
    else:
        assert len(chunks) == 4
        assert float(m["eval_length_mean"]) > 192


def _same_state(a, b):
    assert a.iteration == b.iteration
    for x, y in zip(learner._state_leaves(a), learner._state_leaves(b)):
        assert torch.equal(x, y)
    gens = (a.generators, b.generators) if hasattr(a, "generators") else (
        [a.generator], [b.generator])
    for g, h in zip(*gens):
        assert torch.equal(g.get_state(), h.get_state())


@pytest.mark.parametrize("pop", [False, True], ids=["solo", "p2"])
def test_recording_changes_no_bit(pop):
    """A call of K = 2 and an eval give the same bits with recording on
    (inside a profiler session) and off."""
    cfg = PPOConfig(**TINY)
    if pop:
        loop = population.make_population_loop(cfg, DEFAULT_PARAMS, 2, "cpu")
        ev = population.make_population_eval(cfg, SHORT, device="cpu")
    else:
        loop = learner.make_train_loop(cfg, DEFAULT_PARAMS, 2, "cpu")
        ev = learner.make_eval_fn(cfg, SHORT, device="cpu")
    init = _pop_state if pop else _solo_state
    out = []
    for on in (False, True):
        with (torch.profiler.profile(activities=[CPU]) if on
              else contextlib.nullcontext()):
            state, m = loop(init(cfg))
            e = ev(state.params, torch.Generator().manual_seed(5))
        out.append((state, m, e))
    (a, ma, ea), (b, mb, eb) = out
    _same_state(a, b)
    for got, want in ((ma, mb), (ea, eb)):
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
    names = _names()
    assert names.count("learner.call") == 1 and names.count("eval") == 1
    assert names.count("iteration.update") == 2


# ----------------------------------------------------------------- card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD = dict(TINY, n_envs=1024, n_steps=32, fused_chunk=16,
            minibatch_size=8192, total_timesteps=64 * 1024 * 32)


def _marks(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ev = sorted((e for e in events if e.get("cat") == "kernel"
                 and phase_mark.KERNEL in e.get("name", "")),
                key=lambda e: e["ts"])
    return [e["name"].split(phase_mark.KERNEL)[1].split("(")[0]
            for e in ev]


@pytest.mark.cuda
@pytest.mark.parametrize("pop", [0, 4])
def test_a_replayed_call_carries_four_marks_an_iteration(cuda, pop,
                                                         tmp_path):
    """Two profiled calls of K = 3 (the eager first iteration, the capture
    and two replays; then three replays) launch the four marks of each of
    the six iterations, in order; the loop's spans name the capture once
    and the five replays."""
    cfg = PPOConfig(**CARD)
    if pop:
        init = lambda: population.init_population(  # noqa: E731
            cfg, DEFAULT_PARAMS, pop, "cuda")
        loop = population.make_population_loop(cfg, DEFAULT_PARAMS, 3,
                                                "cuda")
    else:
        init = lambda: learner.init_train_state(  # noqa: E731
            cfg, DEFAULT_PARAMS, "cuda")
        loop = learner.make_train_loop(cfg, DEFAULT_PARAMS, 3, "cuda")
    state = init()
    path = str(tmp_path / "trace.json")
    # a warm-up step first, whose events are dropped: CUPTI can miss the
    # first kernels after the profiler starts
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                         repeat=1),
        on_trace_ready=lambda p: p.export_chrome_trace(path))
    prof.start()
    torch.ones(8, device=cuda).add_(1)
    torch.cuda.synchronize()
    prof.step()
    for _ in range(2):
        state, m = loop(state)
        float(m["loss"].sum())
    prof.step()
    prof.stop()
    assert _marks(path) == list(phase_mark.MARKS) * 6
    names = _names()
    assert names.count("learner.call") == 2
    assert names.count("learner.capture") == 1
    assert names.count("learner.replay") == 5


@pytest.mark.cuda
def test_recording_changes_no_loss_on_the_card(cuda):
    """Two calls of K = 3 and an eval of four members give the same bits
    recorded (the profiler with the card's activity) and not."""
    cfg = PPOConfig(**CARD)
    loop = population.make_population_loop(cfg, DEFAULT_PARAMS, 3, "cuda")
    ev = population.make_population_eval(cfg, DEFAULT_PARAMS,
                                         device="cuda")
    out = []
    for on in (False, True, False):
        state = population.init_population(cfg, DEFAULT_PARAMS, 4, "cuda")
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with (torch.profiler.profile(activities=acts) if on
              else contextlib.nullcontext()):
            rows = []
            for _ in range(2):
                state, m = loop(state)
                rows.append(m["loss"])
            e = ev(state.params, torch.Generator().manual_seed(5))
            torch.cuda.synchronize()
        out.append((state, torch.cat(rows), e))
    assert "eval.chunk" in _names()
    for state, loss, e in out[1:]:
        _same_state(out[0][0], state)
        assert torch.equal(out[0][1], loss)
        for k in e:
            assert torch.equal(out[0][2][k], e[k]), k


@pytest.mark.cuda
def test_the_unfused_path_builds_the_marks_alone(cuda, tmp_path,
                                                 monkeypatch):
    """A solo iteration on the unfused rollout and update, with no library
    built, builds the marks' library and no other: the marks need `nvcc`,
    the kernels of the fused paths do not come with them."""
    from acas2d_tpu_torch.ops import _cuda
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(phase_mark, "_FNS", {})
    cfg = PPOConfig(**dict(CARD, fused_rollout=False, fused_update=False))
    step = learner.make_train_step(cfg, DEFAULT_PARAMS, "cuda")
    _, m = step(learner.init_train_state(cfg, DEFAULT_PARAMS, "cuda"))
    assert torch.isfinite(m["loss"]).all()
    assert [p.name.split("-")[0] for p in tmp_path.glob("*.so")] \
        == ["libphase_mark"]
