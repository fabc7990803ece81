"""The greedy eval's env step kernel (`ops/greedy_step.py`,
`csrc/greedy_step.cu`) against the eager step it replaces.

On the card (tests marked `cuda`, skipped without one; run them there with
`python -m pytest --noconftest tests/test_torch_greedy_step.py -q`): the
kernel's carry after every step of a 64-step chunk equals the eager step's
(`greedy_step.step_plain`: `core.step` and the first episode's
bookkeeping, as torch's CUDA ops compute them) bit for bit, every field,
in float32 and float64, with one or three traffic slots and every traffic
count between `min_traffic` and `max_traffic`, `bug_compat` on and off, on
states that reach the goal, collide, time out and fly across the 0/360
heading wrap, at the population eval's shape (32 x 32 envs, float32) and
the flagship's exact eval's (100 envs, float64); and `GreedyEval`, whose
CUDA graphs launch the kernel, equals the eager `greedy_rollout` on the
card and counts its launches.

On the CPU: the wrapper refuses a mixed dtype, a non-contiguous or a
wrongly shaped operand before it loads the kernel's library, runs the
plain step in place on CPU tensors, and the CPU eval counts no kernel
launch (`eval.step_launches`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS, EnvParams
from acas2d_tpu_torch.envs import core, vector
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops import greedy_step
from acas2d_tpu_torch.ppo import learner
from acas2d_tpu_torch.types import EnvState
from acas2d_tpu_torch.utils import profiling

BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def carry_of(p: EnvParams, B: int, dtype, seed: int, device):
    """A greedy carry of B envs: spawns scattered over the airspace, with
    every traffic count from min_traffic to max_traffic, an eighth of the
    envs a few steps from the goal, an eighth a few steps from a
    collision, an eighth heading across the 0/360 wrap, step counters up
    to past max_steps, and first episodes partly ended."""
    g = torch.Generator().manual_seed(seed)
    es, obs = core.reset(B, p, g, dtype, "cpu")

    def u(*shape):
        return torch.rand(*shape, generator=g, dtype=torch.float64)

    span = p.max_traffic - p.min_traffic + 1
    es = es.replace(
        px=(u(B) * p.width).to(dtype), py=(u(B) * p.height).to(dtype),
        ppsi=(u(B) * 360).to(dtype),
        num_traffic=(p.min_traffic + torch.arange(B) % span).to(torch.int32),
        steps=torch.randint(0, p.max_steps + 3, (B,), generator=g,
                            dtype=torch.int32))
    k = B // 8
    es.px[:k] = (p.goal_x - p.goal_radius - 3 + u(k) * 4).to(dtype)
    es.py[:k] = (p.goal_y + u(k) * 10 - 5).to(dtype)
    es.ppsi[:k] = (u(k) * 2 - 1).remainder(360).to(dtype)
    es.tx[k:2 * k, 0] = es.px[k:2 * k] + 2 * p.collision_radius + 2
    es.ty[k:2 * k, 0] = es.py[k:2 * k]
    es.tpsi[k:2 * k, 0] = 180.0
    es.ppsi[k:2 * k] = 0.0
    wrap = torch.tensor([359.9999, 0.0001, 0.0, 359.99999, 360.0])
    es.ppsi[2 * k:3 * k] = wrap[torch.arange(k) % 5].to(dtype)
    es.tpsi[2 * k:3 * k] = wrap[torch.arange(k * p.max_traffic)
                                % 5].view(k, -1).to(dtype)
    carry = (es, obs, (u(B) * 100 - 50).to(dtype),
             torch.randint(0, 50, (B,), generator=g, dtype=torch.int32),
             torch.randint(0, 4, (B,), generator=g, dtype=torch.int32),
             torch.rand(B, generator=g) < 0.25)
    return tuple(_to(x, device) for x in carry)


def _to(x, device):
    if isinstance(x, EnvState):
        return EnvState(**{f.name: getattr(x, f.name).to(device)
                           for f in dataclasses.fields(EnvState)})
    return x.to(device)


def clone(carry):
    return tuple(learner._clone(x) for x in carry)


def differences(got, want):
    """[(operand, envs that differ, the first such env, its values in
    `got` and in `want`)] over the carries' tensors, floats compared bit
    for bit."""
    out = []
    for name, g, w in zip(greedy_step.OPERANDS, greedy_step.leaves(got),
                          greedy_step.leaves(want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            out.append((name, "dtype or shape", (g.dtype, g.shape)))
            continue
        gb, wb = g, w
        if g.is_floating_point():
            gb, wb = g.view(BITS[g.dtype]), w.view(BITS[w.dtype])
        bad = (gb != wb).reshape(g.shape[0], -1).any(1)
        if bool(bad.any()):
            e = int(bad.nonzero()[0, 0])
            out.append((name, int(bad.sum()), e, g[e].tolist(),
                        w[e].tolist()))
    return out


def run_chunk(p, B, dtype, seed, dev, mean_dtype=torch.float32, steps=64):
    """`steps` greedy steps from `carry_of`, eagerly and by the kernel,
    on the same means (drawn in [-1.5, 1.5], so both clamps act); returns
    [(step, differences)] of the steps whose carries differ, and the
    number of envs that ended an episode along the way, by outcome."""
    want = carry_of(p, B, dtype, seed, dev)
    got = clone(want)
    g = torch.Generator().manual_seed(seed + 1)
    n0 = greedy_step.greedy_step.launches
    bad, ends = [], torch.zeros(4, dtype=torch.int64)
    for t in range(steps):
        mean = (torch.rand(B, generator=g, dtype=torch.float64) * 3
                - 1.5).to(dev, mean_dtype)
        want = greedy_step.step_plain(want, mean, p)
        greedy_step.greedy_step(got, mean, p)
        ends += torch.bincount(want[0].outcome.cpu().long(), minlength=4)
        diff = differences(got, want)
        if diff:
            bad.append((t, diff))
    torch.cuda.synchronize()
    assert greedy_step.greedy_step.launches == n0 + steps
    return bad, ends


CASES = [(dt, B, mt, lo, bug)
         for dt, B in ((torch.float32, 1024), (torch.float64, 100))
         for mt, lo in ((1, 1), (3, 1), (3, 0))
         for bug in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,max_traffic,min_traffic,bug_compat", CASES)
def test_kernel_chunk_equals_the_eager_steps_bit_for_bit(
        cuda, dtype, B, max_traffic, min_traffic, bug_compat):
    p = EnvParams(max_traffic=max_traffic, min_traffic=min_traffic,
                  bug_compat=bug_compat)
    bad, ends = run_chunk(p, B, dtype, 7, cuda)
    assert not bad, bad[:3]
    # the chunk ran through every outcome
    assert bool((ends[1:] > 0).all()), ends


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,mean_dtype", [
    (torch.float32, torch.float64), (torch.float64, torch.float64),
    (torch.float64, torch.float32)])
def test_kernel_takes_the_mean_in_either_dtype(cuda, dtype, mean_dtype):
    bad, _ = run_chunk(DEFAULT_PARAMS, 256, dtype, 9, cuda, mean_dtype, 8)
    assert not bad, bad[:3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_equals_the_eager_steps_from_spawns_to_the_end(cuda, dtype):
    """Fresh spawns under a turning policy's means for a whole episode
    budget (1,000 steps, every env times out or ends), chunk by chunk."""
    B = 1024 if dtype == torch.float32 else 100
    es, obs = vector.reset_batch(B, DEFAULT_PARAMS,
                                 torch.Generator().manual_seed(4), dtype,
                                 cuda)
    want = learner._greedy_start(es, obs)
    got = clone(want)
    g = torch.Generator(device=cuda).manual_seed(6)
    for t in range(DEFAULT_PARAMS.max_steps):
        mean = torch.randn(B, generator=g, device=cuda) * 0.3 + 0.2
        want = greedy_step.step_plain(want, mean, DEFAULT_PARAMS)
        greedy_step.greedy_step(got, mean, DEFAULT_PARAMS)
        if t % learner.GREEDY_CHUNK == learner.GREEDY_CHUNK - 1:
            assert not differences(got, want), (t, differences(got, want))
    assert not differences(got, want)
    assert bool(want[-1].all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["members", "exact"])
def test_greedy_eval_on_the_card_equals_the_eager_loop_and_counts(cuda,
                                                                  kind):
    """`GreedyEval` (the kernel in replayed chunk graphs) against the eager
    `greedy_rollout` on the card, at the population eval's shape with
    random members and at the flagship's in float64, on fresh spawns; the
    kernel's launches counted are the steps of the chunks replayed."""
    gen = torch.Generator().manual_seed(8)
    if kind == "members":
        params = torch.stack([flatten(ActorCritic(generator=gen))
                              for _ in range(32)]).to(cuda)
        greedy = learner.GreedyEval(members=True, device=cuda)
        es, obs = vector.reset_batch(32 * 32, DEFAULT_PARAMS, gen,
                                     torch.float32, cuda)
    else:
        params = flatten(ActorCritic(generator=gen)).to(cuda)
        greedy = learner.GreedyEval(device=cuda)
        es, obs = vector.reset_batch(100, DEFAULT_PARAMS, gen, torch.float64,
                                     cuda)
    eager = learner.greedy_rollout(lambda o: greedy.policy_mean(params, o),
                                   es, obs, DEFAULT_PARAMS)
    greedy(params, es, obs, DEFAULT_PARAMS)          # the capture
    n0 = greedy_step.greedy_step.launches
    profiling.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        got = greedy(params, es, obs, DEFAULT_PARAMS)
    counters = profiling.counters()
    steps = min(counters["eval.chunks"] * learner.GREEDY_CHUNK,
                DEFAULT_PARAMS.max_steps)
    assert counters["eval.step_launches"] == steps
    assert greedy_step.greedy_step.launches == n0 + steps
    assert counters["eval.chunks"] > 1
    for k, v in eager.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ----------------------------------------------------------- on the CPU

def _cpu_carry(dtype=torch.float32, p=DEFAULT_PARAMS, B=8):
    return carry_of(p, B, dtype, 1, "cpu")


def _replaced(carry, name, fn):
    """The carry with operand `name` replaced by fn(it)."""
    if name in {f.name for f in dataclasses.fields(EnvState)}:
        es = carry[0]
        return (es.replace(**{name: fn(getattr(es, name))}),) + carry[1:]
    i = greedy_step.OPERANDS.index(name) - len(dataclasses.fields(EnvState))
    return carry[:i + 1] + (fn(carry[i + 1]),) + carry[i + 2:]


REFUSED = [
    ("tx", lambda t: t.double(), "float32"),
    ("ret", lambda t: t.double(), "float32"),
    ("steps", lambda t: t.long(), "int32"),
    ("done_seen", lambda t: t.int(), "bool"),
    ("obs", lambda t: t[:, :7], "shape"),
    ("tpsi", lambda t: t.repeat(1, 2), "shape"),
    ("length", lambda t: t[:4], "shape"),
    ("obs", lambda t: t.t().contiguous().t(), "contiguous"),
    ("px", lambda t: t.repeat(2)[::2], "contiguous"),
]


@pytest.fixture
def no_library(monkeypatch):
    """Fails a test that reaches the kernel's library."""
    def load():
        raise AssertionError("the kernel's library was loaded")
    monkeypatch.setattr(greedy_step, "_kernel", load)


@pytest.mark.parametrize("name,change,match", REFUSED)
def test_wrapper_refuses_a_bad_operand_before_loading(no_library, name,
                                                      change, match):
    carry = _replaced(_cpu_carry(), name, change)
    mean = torch.zeros(8)
    n0 = greedy_step.greedy_step.launches
    with pytest.raises(ValueError, match=match):
        greedy_step.greedy_step(carry, mean, DEFAULT_PARAMS)
    assert greedy_step.greedy_step.launches == n0


@pytest.mark.parametrize("mean", [torch.zeros(8, dtype=torch.int32),
                                  torch.zeros(8, dtype=torch.float16),
                                  torch.zeros(7), torch.zeros(16)[::2]])
def test_wrapper_refuses_a_bad_mean(no_library, mean):
    with pytest.raises(ValueError, match="mean"):
        greedy_step.greedy_step(_cpu_carry(), mean, DEFAULT_PARAMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("max_traffic", [1, 3])
def test_cpu_step_in_place_equals_the_plain_step(dtype, max_traffic):
    p = EnvParams(max_traffic=max_traffic)
    want = _cpu_carry(dtype, p, 64)
    got = clone(want)
    for t in range(5):
        mean = torch.linspace(-1.5, 1.5, 64) * (t - 2)
        want = greedy_step.step_plain(want, mean, p)
        greedy_step.greedy_step(got, mean, p)
        assert not differences(got, want), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_constants_are_values_of_the_env_dtype(dtype):
    """Every constant is a value of the env's dtype, and each reciprocal is
    1 over the scalar, rounded once in that dtype."""
    t = np.float32 if dtype == torch.float32 else np.float64
    c = greedy_step.constants(DEFAULT_PARAMS, dtype)
    for k, v in c.items():
        assert float(t(v)) == v, k
    assert c["inv360"] == float(t(1) / t(360))
    assert c["inv_vdt"] == float(t(1) / t(DEFAULT_PARAMS.airspeed
                                           * DEFAULT_PARAMS.dt))
    assert c["inv_max_steps"] == float(t(1) / t(1000))
    assert set(c) == set(greedy_step._FLOAT_CONSTS + greedy_step._INT_CONSTS)


def test_the_cpu_eval_counts_no_kernel_launch():
    greedy = learner.GreedyEval(device="cpu")
    params = flatten(ActorCritic(generator=torch.Generator().manual_seed(2)))
    es, obs = vector.reset_batch(4, DEFAULT_PARAMS,
                                 torch.Generator().manual_seed(3),
                                 torch.float32, "cpu")
    n0 = greedy_step.greedy_step.launches
    profiling.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        greedy(params, es, obs, DEFAULT_PARAMS)
    counters = profiling.counters()
    assert counters["eval.chunks"] >= 1
    assert counters.get("eval.step_launches", 0) == 0
    assert greedy_step.greedy_step.launches == n0
