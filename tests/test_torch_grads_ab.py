"""The gradient kernel's A/B tool (`python -m acas2d_tpu_torch.grads_ab`)
on the CPU: each variant's text edits still apply to csrc/ppo_grads.cu or
csrc/tf32x3.cuh (so a later edit of the sources cannot silently turn a
variant into the kernel itself), and without a card the tool refuses to
run."""

import pytest
import torch

from acas2d_tpu_torch import ab, grads_ab
from acas2d_tpu_torch.ops import _cuda

FILES = {f: (_cuda.CSRC / f).read_text() for f in grads_ab.FILES}


@pytest.mark.parametrize("variant", sorted(grads_ab.VARIANTS))
def test_variant_edits_apply_to_the_kernel_source(variant):
    edits = grads_ab.VARIANTS[variant]
    edited = ab.variant_files(FILES, edits)
    assert edited != FILES
    for name, old, new in edits:
        assert old in FILES[name] and new in edited[name]


def test_an_edit_that_matches_nothing_is_refused():
    with pytest.raises(ValueError, match="matches nothing"):
        ab.variant_files(FILES, [("ppo_grads.cu", "no such text", "")])


def test_tool_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert grads_ab.main([]) == 1
