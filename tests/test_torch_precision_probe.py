"""The port's operand-precision probe (plain version,
ops/precision_probe.py) vs `jnp.dot` in the three forms of the Pallas probe
`scripts/pallas_tpu_check.py:244` (`_probe_kernel`), float32 on the CPU.

On the probe's own input (every entry of A is 1 + 2^-12, B the identity)
the three outputs are exact and must be equal bit for bit: the default and
HIGHEST products keep 1 + 2^-12, the bf16 one gives 1.  On random inputs the
default and bf16 forms sum 128 products in another order than XLA, so they
agree to 1e-5 of the output's scale; the float64 form to 1e-6.
`quantizes_operands()` is False on the CPU for both packages: neither
rounds a float32 product's operands.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acas2d_tpu_torch.ops import precision_probe as pp


def _jax_probe(a, b):
    a, b = jnp.asarray(a), jnp.asarray(b)
    o_def = jnp.dot(a, b, preferred_element_type=jnp.float32)
    o_bf = jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    o_hi = jnp.dot(a, b, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return [np.asarray(o, np.float32) for o in (o_def, o_bf, o_hi)]


def test_probe_input_is_exact_in_both():
    a, b = pp.probe_inputs("cpu")
    got = [o.numpy() for o in pp.precision_probe(a, b)]
    want = _jax_probe(a.numpy(), b.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    o_def, o_bf, o_hi = got
    assert (o_def == np.float32(1.0 + 2.0 ** -12)).all()
    assert (o_bf == 1.0).all() and (o_hi == o_def).all()


def test_quantizes_operands_is_false_on_the_cpu():
    assert pp.quantizes_operands("cpu") is False
    o_def, o_bf, o_hi = _jax_probe(*(t.numpy() for t in pp.probe_inputs("cpu")))
    jax_quantizes = bool((o_def == o_bf).all() and not (o_def == o_hi).all())
    assert jax_quantizes is False


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_matches_jnp_dot_on_random_inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(128, 128)).astype(np.float32)
    b = rng.normal(size=(128, 128)).astype(np.float32)
    got = pp.precision_probe(torch.as_tensor(a), torch.as_tensor(b))
    for g, w, tol in zip(got, _jax_probe(a, b), (1e-5, 1e-5, 1e-6)):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * scale)
    o_def, o_bf, _ = (g.numpy() for g in got)
    assert not np.array_equal(o_def, o_bf)      # bf16 rounding shows


def test_probe_checks_operands():
    with pytest.raises(ValueError):
        pp.precision_probe(torch.zeros(64, 128), torch.zeros(128, 128))
    n0 = pp.precision_probe.launches
    with pytest.raises(ValueError, match="CUDA"):
        pp._probe_cuda(*pp.probe_inputs("cpu"))
    assert pp.precision_probe.launches == n0
