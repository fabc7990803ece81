"""The gradient kernel's A/B tool (`python -m acas2d_tpu_torch.grads_ab`)
on the CPU: each variant's text edits still apply to csrc/ppo_grads.cu (so
a later edit of the source cannot silently turn a variant into the kernel
itself), and without a card the tool refuses to run."""

import pytest
import torch

from acas2d_tpu_torch import grads_ab
from acas2d_tpu_torch.ops import _cuda

SOURCE = (_cuda.CSRC / "ppo_grads.cu").read_text()


@pytest.mark.parametrize("variant", sorted(grads_ab.VARIANTS))
def test_variant_edits_apply_to_the_kernel_source(variant):
    edited = grads_ab.variant_source(SOURCE, grads_ab.VARIANTS[variant])
    assert edited != SOURCE
    for old, new in grads_ab.VARIANTS[variant]:
        assert old in SOURCE and new in edited


def test_an_edit_that_matches_nothing_is_refused():
    with pytest.raises(ValueError, match="matches nothing"):
        grads_ab.variant_source(SOURCE, [("no such text", "")])


def test_tool_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert grads_ab.main([]) == 1
