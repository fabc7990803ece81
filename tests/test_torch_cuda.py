"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions (same inputs, same card), plus the wrappers' operand checks.

Each kernel serves one policy (P = 1) and a population's P members in one
launch; both are checked, and so are the member launches' bit-identity
with the solo launch and across repeated launches.  The env-only rollout,
the gradient kernel's bf16 variant and the precision probe are checked the
same way.

Tests marked `cuda` skip without a CUDA device; a skip is unverified, not a
pass.  On a machine with a card, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX, which this file does not
use).  Tolerances are chip_smoke.py's, for the reasons stated there.
"""

import json
import os

import numpy as np
import pytest
import torch

from acas2d_tpu_torch import ab, policy_ab, train
from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import core, vector
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.oracle import MersenneSpawner
from acas2d_tpu_torch.ops import (_cuda, env_rollout, policy_rollout,
                                  ppo_grads, precision_probe)
from acas2d_tpu_torch.ops import step_math as sm
from acas2d_tpu_torch.ppo import learner, population
from acas2d_tpu_torch.utils.params_io import load_flat_params
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-4, 1e-3
GRAD_REL_TOL = 1e-4
FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "ppo_tpu_e_polished_best.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rollout_args(B, K, dev, seed=7, P=1):
    """Operands of _rollout_cuda / _rollout_plain: P members of B envs."""
    gen = torch.Generator().manual_seed(seed)
    params = torch.stack([flatten(ActorCritic(generator=gen))
                          for _ in range(P)])
    params[:, -1] = -0.5
    es, obs = vector.reset_batch(P * B, DEFAULT_PARAMS, gen, torch.float32,
                                 "cpu")
    steps = torch.randint(1, DEFAULT_PARAMS.max_steps + 1, (P * B,),
                          generator=gen)
    st = torch.stack([es.px, es.py, es.ppsi, es.tx[:, 0], es.ty[:, 0],
                      es.tv[:, 0], es.tpsi[:, 0], es.total_reward])
    return (sm.kernel_constants(DEFAULT_PARAMS), DEFAULT_PARAMS.max_steps,
            st.to(dev), steps.to(dev, torch.int32), obs.to(dev),
            params.to(dev), seed, 5, K)


def _grad_args(n, dev, seed=3, P=1):
    """Operands of _grads_cuda / _grads_plain_members: P minibatches."""
    gen = torch.Generator().manual_seed(seed)
    params, datas = [], []
    for _ in range(P):
        model = ActorCritic(generator=gen)
        data = torch.randn(n, 13, generator=gen) * 0.5
        with torch.no_grad():
            mean, log_std, value = model(data[:, :8])
            data[:, 8] = mean[:, 0] + torch.randn(n, generator=gen) * 0.7
            data[:, 9] = (-0.5 * ((data[:, 8] - mean[:, 0]) ** 2
                                  + ppo_grads.LOG_2PI)
                          + torch.randn(n, generator=gen) * 0.3)
        params.append(flatten(model))
        datas.append(data)
    data = ppo_grads.normalize_adv_column(torch.stack(datas)).to(dev)
    return (torch.stack(params).to(dev), data,
            ppo_grads._constants(n, 0.2, 0.5), 0.01)


def _assert_rollout_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            assert torch.allclose(g, w, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(2048, 16), (1000, 3), (2040, 4)])
def test_rollout_kernel_matches_plain(cuda, B, K):
    args = _rollout_args(B, K, cuda)
    n0 = policy_rollout.fused_policy_rollout_members.launches
    got = policy_rollout._rollout_cuda(*args)
    want = policy_rollout._rollout_plain(*args)
    torch.cuda.synchronize()
    assert policy_rollout.fused_policy_rollout_members.launches == n0 + 1
    _assert_rollout_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("P,B,K", [(4, 1024, 8), (3, 200, 2), (32, 1000, 2),
                                   (8, 1024, 16)])
def test_member_rollout_kernel_matches_plain(cuda, P, B, K):
    args = _rollout_args(B, K, cuda, P=P)
    n0 = policy_rollout.fused_policy_rollout_members.launches
    got = policy_rollout._rollout_cuda(*args)
    want = policy_rollout._rollout_plain(*args)
    torch.cuda.synchronize()
    assert policy_rollout.fused_policy_rollout_members.launches == n0 + 1
    _assert_rollout_close(got, want)


@pytest.mark.cuda
def test_member_rollout_p1_and_member0_equal_the_solo_launch(cuda):
    """The solo wrapper is the P = 1 member launch, and member 0 of a
    2-member launch (the global envs 0..B-1) with member 0's weights and
    state is the solo launch, bit for bit."""
    c, ms, st, steps, obs, params, seed, off, K = _rollout_args(1024, 8, cuda,
                                                                P=2)
    B = 1024
    state = dict(zip(policy_rollout.STATE_KEYS, st[:, :B]), steps=steps[:B])
    solo = policy_rollout.fused_policy_rollout(state, obs[:B], params[0],
                                               seed, off, K)
    p1 = policy_rollout.fused_policy_rollout_members(
        {k: v[None] for k, v in state.items()}, obs[None, :B], params[:1],
        seed, off, K)
    two = policy_rollout.fused_policy_rollout_members(
        {k: torch.stack([v, v]) for k, v in state.items()},
        torch.stack([obs[:B], obs[:B]]), params[[0, 0]], seed, off, K)
    torch.cuda.synchronize()
    for k, v in solo[1].items():
        assert torch.equal(v, p1[1][k][:, 0]), k
        assert torch.equal(v, two[1][k][:, 0]), k
    for k, v in solo[0].items():
        assert torch.equal(v, p1[0][k][0]) and torch.equal(v, two[0][k][0]), k
    assert not torch.equal(two[1]["actions"][:, 0], two[1]["actions"][:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("P,B", [(1, 1000), (3, 200), (32, 1000)])
def test_rollout_launch_shapes_agree_bit_for_bit(cuda, P, B):
    """Every row's arithmetic is independent of its tile: any launch shape
    (row tiles a warp, tiles a block) gives the same bits, rows past B in
    a last partial tile included."""
    args = _rollout_args(B, 3, cuda, P=P)
    want = policy_rollout._rollout_cuda(*args)
    for shape in [(1, 1), (1, 2), (1, 4), (2, 1), (2, 4), (2, 8)]:
        got = policy_rollout._rollout_cuda(*args, shape=shape)
        for g, w in zip(got, want):
            assert torch.equal(g, w), shape


@pytest.mark.cuda
@pytest.mark.parametrize("mt", [1, 2])
def test_rollout_kernel_runs_tf32_hmmas_without_spills(cuda, mt):
    """Both towers' products are TF32 tensor-core HMMAs and nothing else;
    no register spills (the stack frame is the IEEE sine's slow path)."""
    census = policy_rollout.sass_census()[mt]
    hmma = [op for op in census if op.startswith("HMMA.")]
    assert hmma and all(".TF32" in op for op in hmma), census
    frames = _cuda.ptxas_frames(_cuda.build_log("policy_rollout"))
    frame = next(v for k, v in frames.items()
                 if f"policy_rollout_kernelILi{mt}E" in k)
    assert frame[1] == frame[2] == 0, frame


@pytest.mark.cuda
@pytest.mark.parametrize("P,B,shape,blocks", [(1, 2048, (1, 1), 128),
                                              (32, 1024, (2, 4), 256),
                                              (8, 1024, (1, 2), 256)],
                         ids=["solo", "members", "sub_minute"])
def test_rollout_launch_shape_at_the_main_path_shapes(cuda, P, B, shape,
                                                      blocks):
    """The solo launch spreads over 128 SMs (blocks of 4 warps); the
    member launch keeps two blocks of 8 warps on an SM; the sub-minute
    command's P = 8 launch has 16-row tiles, two a block of 8 warps."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    mt, w = policy_rollout.launch_shape(P, B, sms)
    assert (mt, w) == shape
    tiles = -(-B // (16 * mt))
    assert P * -(-tiles // w) == blocks
    _, _, smem, per_sm = policy_rollout.kernel_attrs(mt, w)
    assert per_sm >= (2 if P > 1 else 1), (smem, per_sm)


@pytest.mark.cuda
def test_rollout_refused_launch_raises(cuda):
    """A launch the card refuses (blocks of 64 warps, over the card's
    limit) raises and counts no launch."""
    args = _rollout_args(256, 2, cuda)
    n0 = policy_rollout.fused_policy_rollout_members.launches
    with pytest.raises(RuntimeError, match="policy_rollout launch"):
        policy_rollout._rollout_cuda(*args, shape=(1, 16))
    assert policy_rollout.fused_policy_rollout_members.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("P,B", [(1, 2048), (32, 1024)],
                         ids=["solo", "members"])
def test_rollout_separating_check_fails_a_1xtf32_build(cuda, P, B):
    """chip_smoke.py's bound on the values' and actions' errors holds the
    kernel and fails a build whose products are 1xTF32."""
    dirs = ab.source_dirs("policy", policy_ab.FILES, policy_ab.VARIANTS,
                          ["onex_tf32"], {})
    libs = ab.build("policy_rollout.cu", {"onex_tf32": dirs["onex_tf32"]},
                    "policy")
    args = policy_ab.operands(cuda, P, B)
    want = policy_ab.named(policy_rollout._rollout_plain(
        *(a.cpu() if torch.is_tensor(a) else a for a in args)))
    got = policy_ab.named(policy_rollout._rollout_cuda(*args))
    onex = policy_ab.named(policy_rollout._rollout_cuda(
        *args, lib=libs["onex_tf32"]))
    torch.cuda.synchronize()
    assert all(ok for _, _, ok in policy_ab.separating(got, want).values())
    assert not all(ok for _, _, ok in policy_ab.separating(onex,
                                                           want).values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 1000, 64])
def test_grads_kernel_matches_plain(cuda, n):
    args = _grad_args(n, cuda)
    n0 = ppo_grads.ppo_minibatch_grads_members.launches
    g, s = ppo_grads._grads_cuda(*args)
    w, ws = ppo_grads._grads_plain_members(*args)
    torch.cuda.synchronize()
    assert ppo_grads.ppo_minibatch_grads_members.launches == n0 + 1
    assert torch.isfinite(g).all()
    assert ((g - w).abs().max() / w.abs().max()) < GRAD_REL_TOL
    assert torch.allclose(s, ws, rtol=GRAD_REL_TOL, atol=1e-3)
    # deterministic: the two-pass reduction has no atomics
    g2, s2 = ppo_grads._grads_cuda(*args)
    assert torch.equal(g, g2) and torch.equal(s, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("P,n", [(8, 8192), (3, 1000), (32, 32768),
                                 (32, 1000), (8, 32768)])
def test_member_grads_kernel_matches_plain_and_repeats(cuda, P, n):
    args = _grad_args(n, cuda, P=P)
    g, s = ppo_grads._grads_cuda(*args)
    w, ws = ppo_grads._grads_plain_members(*args)
    g2, s2 = ppo_grads._grads_cuda(*args)
    torch.cuda.synchronize()
    assert g.shape == w.shape == (P, 9603) and s.shape == ws.shape == (P, 4)
    for m in range(P):
        assert ((g[m] - w[m]).abs().max() / w[m].abs().max()) < GRAD_REL_TOL
    assert torch.allclose(s, ws, rtol=GRAD_REL_TOL, atol=1e-3)
    assert torch.equal(g, g2) and torch.equal(s, s2)


@pytest.mark.cuda
def test_member_grads_sum_a_cancelling_value_head_bias(cuda):
    """The value head's bias gradient is one float32 sum over a member's
    rows of dvalue_scale * (value - return).  With the value head's weights
    zero the value is its bias exactly, so the kernel sums the same float32
    terms as here; returns drawn about it cancel the sum to ~1 / 40,000 of
    its terms.  The kernel holds the terms' exact sum within GRAD_REL_TOL
    (3.5e-5 on the CPU emulation of its order); plain float32 running sums
    over a block's rows err up to 1.3e-4."""
    P, n = 32, 32768
    params, data, c, ent = _grad_args(n, cuda, P=P)
    params, data = params.cpu(), data.cpu()
    wh = slice(4801 + 4736, 4801 + 4800)     # the value tower's w_head
    params[:, wh] = 0.0
    bh = params[:, 4801 + 4800]
    gen = torch.Generator().manual_seed(9)
    for m in range(P):
        noise = torch.randn(n, generator=gen, dtype=torch.float64) * 0.5
        data[m, :, 12] = (bh[m].double() + noise - noise.mean()
                          + 1e-5).float()
    g, _ = ppo_grads._grads_cuda(params.to(cuda), data.to(cuda), c, ent)
    terms = (torch.tensor(c["dvalue_scale"], dtype=torch.float32)
             * (bh[:, None] - data[:, :, 12]))
    want = terms.double().sum(1)
    got = g[:, 4801 + 4800].cpu().double()
    assert float(((got - want).abs() / want.abs()).max()) < GRAD_REL_TOL


@pytest.mark.cuda
def test_member_grads_p1_equals_the_solo_launch(cuda):
    params, data, c, ent = _grad_args(4096, cuda, P=1)
    kw = dict(clip_range=0.2, vf_coef=0.5, ent_coef=ent)
    g, aux = ppo_grads.ppo_minibatch_grads(params[0], data[0], **kw)
    gm, auxm = ppo_grads.ppo_minibatch_grads_members(params, data, **kw)
    torch.cuda.synchronize()
    assert torch.equal(g, gm[0])
    for k, v in aux.items():
        assert torch.equal(v, auxm[k][0]), k



@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1, 65536), (64, 1, 65536),
                                   (4, 32, 32768), (3, 2, 1000)],
                         ids=["solo_tpu", "solo32k", "pop32", "odd"])
def test_adv_norm_kernel_matches_float64(cuda, shape):
    """The epoch's normalisation at each training cell's shape
    (chip_smoke.py phase 20): every advantage within 4 ulps, and every
    mean and std within 2 ulps, of the float64 statistics rounded once; a
    cancelling column (mean 1e4, std 1e-2) and a constant one (0 / 1e-8)
    included; the other columns untouched; two launches bit for bit."""
    import chip_smoke
    x = chip_smoke.adv_norm_inputs(cuda, shape)
    n0 = ppo_grads.normalize_adv_minibatches.launches
    err, stats_err = chip_smoke.adv_norm_errors(x)
    torch.cuda.synchronize()
    assert ppo_grads.normalize_adv_minibatches.launches == n0 + 4
    assert err <= chip_smoke.ADV_NORM_ULPS == 4
    assert stats_err <= chip_smoke.ADV_STATS_ULPS == 2


@pytest.mark.cuda
def test_adv_norm_kernel_in_float64_matches_two_passes(cuda):
    """float64 epochs (the unfused float64 update on the card) against
    two passes on the CPU, the mean and then the squares about it: the
    means and stds within 1e-12 of their size, each advantage within
    1e-9 (the cancelling column's x - mean carries 1e4 x 2^-52 over a std
    of 1e-2); the other columns untouched."""
    import chip_smoke
    x = chip_smoke.adv_norm_inputs(cuda, (4, 3, 5000), torch.float64)
    got = x.clone()
    stats = ppo_grads.normalize_adv_minibatches(got).cpu()
    adv = x[..., 11].cpu()
    mean = adv.mean(-1, keepdim=True)
    std = ((adv - mean) ** 2).mean(-1, keepdim=True).sqrt()
    assert torch.allclose(stats, torch.cat([mean, std], -1), rtol=1e-12,
                          atol=0)
    want = (adv - mean) / (std + 1e-8)
    assert (got[..., 11].cpu() - want).abs().max() < 1e-9
    assert torch.equal(got[..., :11], x[..., :11])


@pytest.mark.cuda
def test_adv_norm_kernel_replays_in_a_graph_and_counts(cuda):
    """Captured in a CUDA graph, each replay normalises the static input as
    an eager launch does; the capture counts its two launches, as a
    replayed training iteration counts them (`learner.KERNELS`)."""
    import chip_smoke
    x = chip_smoke.adv_norm_inputs(cuda, (4, 2, 8192))
    eager = x.clone()
    ppo_grads.normalize_adv_minibatches(eager)
    static = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    n0 = ppo_grads.normalize_adv_minibatches.launches
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        ppo_grads.normalize_adv_minibatches(static)
    torch.cuda.current_stream().wait_stream(stream)
    assert ppo_grads.normalize_adv_minibatches.launches == n0 + 2
    assert "adv_norm" in learner.KERNELS
    for _ in range(2):
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, eager)


def _env_state(B, dev, seed=5):
    """Fresh spawns with part-way step counters, so that timeouts respawn
    inside a short launch."""
    gen = torch.Generator().manual_seed(seed)
    es, _ = vector.reset_batch(B, DEFAULT_PARAMS, gen, torch.float32, "cpu")
    st = env_rollout.flat_state(es)
    st["steps"] = torch.randint(1, DEFAULT_PARAMS.max_steps + 1, (B,),
                                generator=gen, dtype=torch.int32)
    return {k: v.to(dev) for k, v in st.items()}


def assert_env_rollout_close(got, want, T):
    """The kernel's outputs against the plain version's by the rule of
    `env_rollout.agreement`, which chip_smoke.py applies too."""
    _, _, failed = env_rollout.agreement(got, want, T)
    assert not failed, failed


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(2048, 64), (3072, 5)])
@pytest.mark.parametrize("mode", [dict(), dict(with_obs=True),
                                  dict(zero_actions=True, with_obs=True)],
                         ids=["random", "random_obs", "zero_obs"])
def test_env_rollout_kernel_matches_plain(cuda, B, T, mode):
    st = _env_state(B, cuda)
    n0 = env_rollout.fused_rollout.launches
    got = env_rollout.fused_rollout(st, 11, T, DEFAULT_PARAMS, **mode)
    want = env_rollout.fused_rollout({k: v.cpu() for k, v in st.items()},
                                     11, T, DEFAULT_PARAMS, **mode)
    torch.cuda.synchronize()
    assert env_rollout.fused_rollout.launches == n0 + 1
    assert_env_rollout_close({**got[0], **got[1]}, {**want[0], **want[1]}, T)
    assert int(want[1]["episodes"].sum()) > 0
    again = env_rollout.fused_rollout(st, 11, T, DEFAULT_PARAMS, **mode)
    for k, v in {**got[0], **got[1]}.items():       # deterministic
        assert torch.equal(v, {**again[0], **again[1]}[k]), k


@pytest.mark.cuda
def test_env_rollout_obs_repeats_bit_for_bit_at_scale(cuda):
    """With obs, a lane that respawned takes another path through the step
    than its warp's other lanes; the results still repeat bit for bit."""
    st = _env_state(32768, cuda)
    got = [env_rollout.fused_rollout(st, 11, 256, DEFAULT_PARAMS,
                                     with_obs=True) for _ in range(2)]
    torch.cuda.synchronize()
    (a, sa), (b, sb) = got
    assert int(sa["episodes"].sum()) > 0
    for k, v in {**a, **sa}.items():
        assert torch.equal(v, {**b, **sb}[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("zero_actions", [False, True])
@pytest.mark.parametrize("with_obs", [False, True])
def test_env_rollout_kernel_uses_no_local_memory(cuda, zero_actions,
                                                 with_obs):
    """The loop's sines are the bounded routine, which has no slow path
    for large arguments: no stack frame, no spill, no local loads or
    stores anywhere in the kernel."""
    regs, local, per_sm = env_rollout.kernel_attrs(zero_actions, with_obs)
    assert local == 0 and per_sm > 0, (regs, local, per_sm)
    census = env_rollout.sass_census()[(zero_actions, with_obs)]
    assert census["kernel"]["LDL"] == census["kernel"]["STL"] == 0, census
    assert census["loop"]["all"] > 0, census


@pytest.mark.cuda
@pytest.mark.parametrize("P,n", [(1, 65536), (1, 1000), (4, 8192),
                                 (32, 32768)])
def test_bf16_grads_kernel_matches_plain(cuda, P, n):
    args = _grad_args(n, cuda, P=P)
    g, s = ppo_grads._grads_cuda(*args, bf16=True)
    w, ws = ppo_grads._grads_plain_members(*args, bf16=True)
    g32, s32 = ppo_grads._grads_cuda(*args)
    torch.cuda.synchronize()
    for m in range(P):
        assert ((g[m] - w[m]).abs().max() / w[m].abs().max()) < GRAD_REL_TOL
        dev = (g[m] - g32[m]).abs().max() / g32[m].abs().max()
        assert 0 < dev <= 3e-2
    assert torch.allclose(s, ws, rtol=GRAD_REL_TOL, atol=1e-3)
    g2, s2 = ppo_grads._grads_cuda(*args, bf16=True)
    assert torch.equal(g, g2) and torch.equal(s, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16,name,kind", [
    (True, "grad_partials_bf16mma", ".BF16")], ids=["bf16"])
def test_grads_kernel_runs_tensor_core_hmmas_at_two_blocks_an_sm(
        cuda, bf16, name, kind):
    """The bf16 first pass multiplies on the tensor cores (mma.sync) in its
    own operand type, and two blocks (16 warps) of it fit on an SM."""
    *_, per_sm = ppo_grads.kernel_attrs(bf16)
    assert per_sm == 2
    ops = _cuda.sass_ops("ppo_grads", [name])[name]
    hmma = [op for op in ops if op.startswith("HMMA")]
    assert hmma and all(kind in op for op in hmma), ops


@pytest.mark.cuda
def test_f32_grads_kernel_runs_tf32_hgmmas_at_one_block_an_sm(cuda):
    """The f32 first pass multiplies on Hopper's warpgroup MMA alone (TF32
    HGMMAs, no mma.sync HMMA), and one block (two warpgroups) fits on an
    SM."""
    *_, per_sm = ppo_grads.kernel_attrs(False)
    assert per_sm == 1
    name = "grad_partials_tf32x3"
    ops = _cuda.sass_ops("ppo_grads", [name])[name]
    hgmma = [op for op in ops if op.startswith("HGMMA")]
    assert hgmma and all(".TF32" in op for op in hgmma), ops
    assert not [op for op in ops if op.startswith("HMMA")], ops


@pytest.mark.cuda
def test_precision_probe_kernel(cuda):
    a, b = precision_probe.probe_inputs(cuda)
    n0 = precision_probe.precision_probe.launches
    o_def, o_bf, o_hi = precision_probe.precision_probe(a, b)
    torch.cuda.synchronize()
    assert precision_probe.precision_probe.launches == n0 + 1
    assert bool((o_def == 1.0 + 2.0 ** -12).all()) and bool((o_bf == 1.0).all())
    assert torch.equal(o_def, o_hi)
    assert precision_probe.quantizes_operands(cuda) is False
    gen = torch.Generator().manual_seed(0)
    x, y = (torch.randn(128, 128, generator=gen) for _ in range(2))
    got = precision_probe.precision_probe(x.to(cuda), y.to(cuda))
    want = precision_probe.precision_probe(x, y)
    for g, w in zip(got, want):
        assert torch.allclose(g.cpu(), w, rtol=0, atol=1e-4)


# ------------------------------------------ greedy eval as CUDA graphs

def _greedy_case(kind, dev):
    """(GreedyEval, params, env_state, obs) of an eval on the card: the
    flagship on 10 sampled spawns in float32 (ends early), on 100 Mersenne
    spawns in float64 (the exact protocol), or 32 random members on 32
    spawns each (time out: the 40-step tail graph runs)."""
    gen = torch.Generator().manual_seed(8)
    if kind == "members":
        params = torch.stack([flatten(ActorCritic(generator=gen))
                              for _ in range(32)]).to(dev)
        es, obs = vector.reset_batch(32 * 32, DEFAULT_PARAMS, gen,
                                     torch.float32, dev)
        return learner.GreedyEval(members=True, device=dev), params, es, obs
    params = load_flat_params(FLAGSHIP)[0].to(dev)
    if kind == "solo":
        es, obs = vector.reset_batch(10, DEFAULT_PARAMS, gen, torch.float32,
                                     dev)
    else:
        inits = MersenneSpawner(DEFAULT_PARAMS,
                                skip_episodes=2).spawn_batch(100)
        es, obs = core.reset_from(
            np.array([i.player_psi for i in inits]),
            np.stack([i.traffic_x for i in inits]),
            np.stack([i.traffic_y for i in inits]),
            np.stack([i.traffic_v for i in inits]),
            np.stack([i.traffic_psi for i in inits]),
            np.array([i.num_traffic for i in inits]),
            DEFAULT_PARAMS, torch.float64, dev)
    return learner.GreedyEval(device=dev), params, es, obs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["solo", "exact", "members"])
def test_greedy_graphs_equal_the_eager_loop(cuda, kind):
    greedy, params, es, obs = _greedy_case(kind, cuda)
    eager = learner.greedy_rollout(lambda o: greedy.policy_mean(params, o),
                                   es, obs, DEFAULT_PARAMS)
    for _ in range(2):           # the capture, then the cached graphs
        got = greedy(params, es, obs, DEFAULT_PARAMS)
        for k, v in eager.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert len(greedy._graphs) == 1
    if kind == "exact":
        assert float(eager["return"].mean()) == pytest.approx(1252.72,
                                                             abs=0.05)


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda, monkeypatch):
    """A host sync inside the loop cannot be captured: the eval raises and
    does not fall back to the eager loop."""
    greedy, params, es, obs = _greedy_case("solo", cuda)
    real = greedy.policy_mean

    def syncs(p, o):
        return real(p, o) + 0.0 * float(o[0, 0])

    monkeypatch.setattr(greedy, "policy_mean", syncs)
    with pytest.raises(RuntimeError):
        greedy(params, es, obs, DEFAULT_PARAMS)
    assert not greedy._graphs
    torch.cuda.synchronize()


# ------------------------------------ the rollout seed in device memory

@pytest.mark.cuda
@pytest.mark.parametrize("P,B", [(1, 2048), (32, 1024)],
                         ids=["solo", "members"])
def test_seed_read_from_memory_equals_the_seed_by_value(cuda, P, B):
    """The kernel reading its seed from a (1,) int32 tensor on the card
    gives the bits of a build that takes it as a kernel argument
    (`policy_ab`'s `seed_by_value` variant), and of an int seed."""
    dirs = ab.source_dirs("policy", policy_ab.FILES, policy_ab.VARIANTS,
                          ["seed_by_value"], {})
    libs = ab.build("policy_rollout.cu",
                    {"seed_by_value": dirs["seed_by_value"]}, "policy")
    assert not policy_rollout.reads_seed(libs["seed_by_value"])
    args = list(policy_ab.operands(cuda, P, B))
    seed = args[6]
    by_value = policy_rollout._rollout_cuda(*args,
                                            lib=libs["seed_by_value"])
    as_int = policy_rollout._rollout_cuda(*args)
    args[6] = torch.tensor([seed], dtype=torch.int32, device=cuda)
    in_memory = policy_rollout._rollout_cuda(*args)
    for a, b, c in zip(in_memory, by_value, as_int):
        assert torch.equal(a, b) and torch.equal(a, c)


# --------------------------------- iterations per call as CUDA graphs

FUSED = ["--fused-rollout", "--fused-update"]


def _loop_case(pop, bf16=False, flags=FUSED, dtype=torch.float32):
    """(config, init(), eager step, loop of K = 3) at a small shape:
    1024 envs x 32 steps (2 rollout launches on the fused rollout),
    minibatch 8192, 2 epochs (8 gradient launches an iteration on the
    fused update), on the paths `flags` ask for."""
    argv = ["--preset", "tpu", "--n-envs", "1024", "--n-steps", "32",
            "--minibatch-size", "8192", "--n-epochs", "2", "--anneal-lr",
            "--total-steps", str(64 * 1024 * 32)] + flags + (
        ["--fused-update-bf16"] if bf16 else [])
    cfg = train.build_config(train.parse_args(argv))
    if pop:
        return (cfg, lambda: population.init_population(
                    cfg, DEFAULT_PARAMS, pop, "cuda", dtype),
                population.make_population_step(cfg, DEFAULT_PARAMS, "cuda",
                                                dtype=dtype),
                population.make_population_loop(cfg, DEFAULT_PARAMS, 3,
                                                "cuda", dtype))
    return (cfg, lambda: learner.init_train_state(cfg, DEFAULT_PARAMS,
                                                  "cuda", dtype=dtype),
            learner.make_train_step(cfg, DEFAULT_PARAMS, "cuda",
                                    dtype=dtype),
            learner.make_train_loop(cfg, DEFAULT_PARAMS, 3, "cuda", dtype))


class _HostCopies(TorchDispatchMode):
    """Records each op that takes a tensor from the host to the card: a
    copy from a CPU tensor, or any op that mixes a CPU tensor of one or
    more dimensions with CUDA tensors."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs)) if torch.is_tensor(t)]
        outs = [t for t in tree_leaves(out) if torch.is_tensor(t)]
        host = [t for t in ins if t.device.type == "cpu"]
        card = [t for t in ins + outs if t.is_cuda]
        if host and card and ("copy" in str(func)
                              or any(t.dim() > 0 for t in host)):
            self.seen.append(str(func))
        return out


@pytest.mark.cuda
@pytest.mark.parametrize("pop,bf16,flags,dtype", [
    (0, False, FUSED, torch.float32), (4, False, FUSED, torch.float32),
    (0, True, FUSED, torch.float32), (0, False, [], torch.float32),
    (0, False, [], torch.float64), (4, False, [], torch.float32),
    (0, False, ["--fused-rollout"], torch.float32),
    (0, False, ["--fused-update"], torch.float32)],
    ids=["solo", "p4", "solo_bf16", "unfused_solo", "unfused_solo_f64",
         "unfused_p4", "fused_rollout_autograd", "unfused_rollout_kernel"])
def test_replayed_iterations_equal_eager_steps(cuda, pop, bf16, flags,
                                               dtype, monkeypatch):
    """Two calls of K = 3 (the first: one eager iteration, the capture,
    two replays; the second: three replays) equal six eager steps bit for
    bit: params, Adam moments and count, env state, obs, every metric and
    the generators.  The launch counters go up by K x 2 rollout and K x 8
    gradient launches a call where those paths are fused, else by none,
    and by K x 4 advantage-normalisation launches (two an epoch) on every
    path,
    and no op inside the capture takes a tensor from the host (the
    unfused rollout's draws are made on the card from the seed; its
    autograd update is captured with it)."""
    cfg, init, step, loop = _loop_case(pop, bf16, flags, dtype)
    a, rows = init(), []
    for _ in range(6):
        a, m = step(a)
        rows.append(m)
    guard = _HostCopies()
    real = learner._IterationGraph.captured

    def captured(self):
        with guard:
            return real(self)

    monkeypatch.setattr(learner._IterationGraph, "captured", captured)
    b, calls = init(), []
    counters = (policy_rollout.fused_policy_rollout_members,
                ppo_grads.ppo_minibatch_grads_members,
                ppo_grads.normalize_adv_minibatches)
    for _ in range(2):
        n0 = [c.launches for c in counters]
        b, m = loop(b)
        torch.cuda.synchronize()
        assert [c.launches - n for c, n in zip(counters, n0)] == [
            6 * cfg.fused_rollout, 24 * cfg.fused_update, 12]
        calls.append(m)
    assert guard.seen == []
    assert b.iteration == a.iteration == 6
    assert b.opt_state.count == a.opt_state.count == 6 * 8
    for x, y in zip(learner._state_leaves(a), learner._state_leaves(b)):
        assert torch.equal(x, y)
    for g, h in zip(a.generators, b.generators):
        assert torch.equal(g.get_state(), h.get_state())
    for k in rows[0]:
        assert torch.equal(torch.stack([r[k] for r in rows]),
                           torch.cat([c[k] for c in calls])), k
    assert len(loop._graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [FUSED, []], ids=["fused", "unfused"])
def test_a_failed_iteration_capture_raises(cuda, flags, monkeypatch):
    """A host sync inside the iteration cannot be captured: the call
    raises, keeps no graph and does not fall back to the eager loop."""
    cfg, init, step, loop = _loop_case(0, flags=flags)
    real = learner.compute_gae

    def syncs(rewards, *args):
        float(rewards.sum())
        return real(rewards, *args)

    monkeypatch.setattr(learner, "compute_gae", syncs)
    with pytest.raises(RuntimeError):
        loop(init())
    assert not loop._graphs
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("pop", [0, 4])
def test_resume_is_exact_on_the_card(cuda, pop, tmp_path):
    """Four iterations straight equal two and a --resume for two more, bit
    for bit, solo (with --exact-eval) and with 4 members."""
    B = 1024 * 32
    argv = FUSED + [
        "--preset", "tpu", "--n-envs", "1024", "--n-steps", "32",
        "--minibatch-size", "8192", "--n-epochs", "2", "--eval-episodes",
        "4", "--eval-every", str(2 * B), "--checkpoint-every", str(B),
        "--run-name", "r"] + (
        ["--population", str(pop), "--reval-episodes", "0"] if pop
        else ["--exact-eval"])

    def run(out, total, *extra):
        train.run(train.parse_args(argv + ["--out-dir", str(out),
                                           "--total-steps", str(total),
                                           *extra]))
        run_dir = out / "r"
        with open(run_dir / "train.jsonl") as f:
            rows = [{k: v for k, v in json.loads(line).items()
                     if k not in ("steps_per_s", "seconds", "wall_time_s")}
                    for line in f]
        return rows, torch.load(run_dir / "checkpoints" / str(total)
                                / "state.pt", weights_only=True)

    rows, want = run(tmp_path / "straight", 4 * B)
    run(tmp_path / "split", 2 * B)
    got_rows, got = run(tmp_path / "split", 4 * B, "--resume")
    assert got_rows == rows and len(rows) == 4
    for k in ("params", "obs"):
        assert torch.equal(got[k], want[k]), k
    for k in ("mu", "nu"):
        assert torch.equal(got["adam"][k], want["adam"][k]), k
    for k, v in want["env_state"].items():
        assert torch.equal(got["env_state"][k], v), k


@pytest.mark.cuda
def test_env_checks_pass_on_the_card(cuda):
    """The env checker on the core and on the legacy gym env, on the card
    (chip_smoke.py phase 18 (a))."""
    import chip_smoke
    chip_smoke.env_checks("cuda")


@pytest.mark.cuda
def test_gym_env_on_the_card_replays_like_the_oracle(cuda):
    """The recorded actions through the float64 legacy gym env on the card
    against the scalar oracle: px within 1e-9, rewards within 1e-12
    (chip_smoke.py phase 18 (b))."""
    import chip_smoke
    steps, _, px_err, r_err = chip_smoke.gym_replay("cuda")
    assert steps > 1 and px_err <= 1e-9 and r_err <= 1e-12


@pytest.mark.cuda
def test_baseline_on_the_card_matches_the_cpu(cuda):
    """`baseline --episodes 20` (zero policy, float64) on the card against
    the CPU: outcomes and steps equal, paths within 1e-9 px, returns
    within 1e-8 (chip_smoke.py phase 18 (c))."""
    import chip_smoke
    runs = chip_smoke.baseline_runs(["cuda", "cpu"], 20)
    chip_smoke.compare_baselines(runs["cuda"][0], runs["cpu"][0])


@pytest.mark.cuda
def test_sharded_replayed_call_over_nccl_counts_its_collectives(cuda,
                                                               tmp_path):
    """Four ranks over NCCL, 1,024 envs a card: a replayed call of 3
    iterations (the first eager, then replays of the captured one, whose
    graph holds the all-reduces and the all-gather) equals 3 eager steps
    bit for bit; the capture's tally is the iteration's collectives (a
    minibatch step's all-reduce each, one of the episode sums, one
    all-gather of the batch), and a profiled call of 3 replays counts
    3 times it (`tests/test_torch_sharded_bench.py card_rank`)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards")
    from acas2d_tpu_torch.parallel import launch
    here = os.path.dirname(os.path.abspath(__file__))
    # by path: a `tests` package elsewhere on the path may shadow this
    # directory's modules under `-m`
    launch.check_ranks(launch.run_ranks(
        [os.path.join(here, "test_torch_sharded_bench.py"), "card",
         str(tmp_path)], 4, 600, cwd=os.path.dirname(here)))
    with open(tmp_path / "card.json") as f:
        got = json.load(f)
    assert got["same"]
    tally = got["tally"]
    assert tally["collective.all_reduce"] == got["steps"] + 1
    assert tally["collective.all_gather"] == 1
    assert tally["collective.all_gather.bytes"] == got["batch_bytes"]
    assert got["counted"] == {k: 3 * v for k, v in tally.items()}


def test_kernel_wrappers_check_operands():
    """The CUDA entry points refuse CPU or mistyped operands before any
    launch (runs without a card: the checks come first)."""
    args = list(_rollout_args(128, 2, torch.device("cpu")))
    n0 = policy_rollout.fused_policy_rollout_members.launches
    with pytest.raises(ValueError, match="CUDA"):
        policy_rollout._rollout_cuda(*args)
    gargs = list(_grad_args(64, torch.device("cpu")))
    with pytest.raises(ValueError, match="CUDA"):
        ppo_grads._grads_cuda(*gargs)
    n_norm = ppo_grads.normalize_adv_minibatches.launches
    with pytest.raises(ValueError, match="CUDA"):
        ppo_grads._normalize_cuda(torch.zeros(2, 64, 13))
    with pytest.raises(ValueError, match="float32 or float64"):
        ppo_grads._normalize_cuda(torch.zeros(2, 64, 13, dtype=torch.half))
    with pytest.raises(ValueError, match=r"\(\.\.\., M, 13\)"):
        ppo_grads.normalize_adv_minibatches(torch.zeros(2, 64, 12))
    assert ppo_grads.normalize_adv_minibatches.launches == n_norm
    assert policy_rollout.fused_policy_rollout_members.launches == n0
    if torch.cuda.is_available():
        args[5] = args[5].cuda()
        args[2] = args[2].double().cuda()
        with pytest.raises(ValueError, match="float32"):
            policy_rollout._rollout_cuda(*args)
