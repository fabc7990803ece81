"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions (same inputs, same card), plus the wrappers' operand checks.

Tests marked `cuda` skip without a CUDA device; a skip is unverified, not a
pass.  On a machine with a card, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX, which this file does not
use).  Tolerances are chip_smoke.py's, for the reasons stated there.
"""

import pytest
import torch

from acas2d_tpu_torch.config import DEFAULT_PARAMS
from acas2d_tpu_torch.envs import vector
from acas2d_tpu_torch.models.actor_critic import ActorCritic, flatten
from acas2d_tpu_torch.ops import policy_rollout, ppo_grads
from acas2d_tpu_torch.ops import step_math as sm

ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-4, 1e-3
GRAD_REL_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rollout_args(B, K, dev, seed=7):
    gen = torch.Generator().manual_seed(seed)
    params = flatten(ActorCritic(generator=gen))
    params[-1] = -0.5
    es, obs = vector.reset_batch(B, DEFAULT_PARAMS, gen, torch.float32,
                                  "cpu")
    steps = torch.randint(1, DEFAULT_PARAMS.max_steps + 1, (B,), generator=gen)
    st = torch.stack([es.px, es.py, es.ppsi, es.tx[:, 0], es.ty[:, 0],
                      es.tv[:, 0], es.tpsi[:, 0], es.total_reward])
    return (sm.kernel_constants(DEFAULT_PARAMS), DEFAULT_PARAMS.max_steps,
            st.to(dev), steps.to(dev, torch.int32), obs.to(dev),
            params.to(dev), seed, 5, K)


def _grad_args(n, dev, seed=3):
    gen = torch.Generator().manual_seed(seed)
    model = ActorCritic(generator=gen)
    data = torch.randn(n, 13, generator=gen) * 0.5
    with torch.no_grad():
        mean, log_std, value = model(data[:, :8])
        data[:, 8] = mean[:, 0] + torch.randn(n, generator=gen) * 0.7
        data[:, 9] = (-0.5 * ((data[:, 8] - mean[:, 0]) ** 2 + ppo_grads.LOG_2PI)
                      + torch.randn(n, generator=gen) * 0.3)
    data = ppo_grads.normalize_adv_column(data).to(dev)
    return (flatten(model).to(dev), data, ppo_grads._constants(n, 0.2, 0.5),
            0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(2048, 16), (1000, 3)])
def test_rollout_kernel_matches_plain(cuda, B, K):
    args = _rollout_args(B, K, cuda)
    n0 = policy_rollout.fused_policy_rollout.launches
    got = policy_rollout._rollout_cuda(*args)
    want = policy_rollout._rollout_plain(*args)
    torch.cuda.synchronize()
    assert policy_rollout.fused_policy_rollout.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            assert torch.allclose(g, w, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 1000, 64])
def test_grads_kernel_matches_plain(cuda, n):
    args = _grad_args(n, cuda)
    n0 = ppo_grads.ppo_minibatch_grads.launches
    g, s = ppo_grads._grads_cuda(*args)
    w, ws = ppo_grads._grads_plain(*args)
    torch.cuda.synchronize()
    assert ppo_grads.ppo_minibatch_grads.launches == n0 + 1
    assert torch.isfinite(g).all()
    assert ((g - w).abs().max() / w.abs().max()) < GRAD_REL_TOL
    assert torch.allclose(s, ws, rtol=GRAD_REL_TOL, atol=1e-3)
    # deterministic: the two-pass reduction has no atomics
    g2, s2 = ppo_grads._grads_cuda(*args)
    assert torch.equal(g, g2) and torch.equal(s, s2)


def test_kernel_wrappers_check_operands():
    """The CUDA entry points refuse CPU or mistyped operands before any
    launch (runs without a card: the checks come first)."""
    args = list(_rollout_args(128, 2, torch.device("cpu")))
    n0 = policy_rollout.fused_policy_rollout.launches
    with pytest.raises(ValueError, match="CUDA"):
        policy_rollout._rollout_cuda(*args)
    gargs = list(_grad_args(64, torch.device("cpu")))
    with pytest.raises(ValueError, match="CUDA"):
        ppo_grads._grads_cuda(*gargs)
    assert policy_rollout.fused_policy_rollout.launches == n0
    if torch.cuda.is_available():
        args[2] = args[2].double().cuda()
        with pytest.raises(ValueError, match="float32"):
            policy_rollout._rollout_cuda(*args)
