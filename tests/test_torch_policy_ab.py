"""The policy rollout's A/B tool (`python -m acas2d_tpu_torch.policy_ab`) on
the CPU: each variant's text edits still apply to csrc/policy_rollout.cu
or csrc/tf32x3.cuh (so a later edit of the sources cannot silently turn a
variant into the kernel itself), and without a card the tool refuses to
run."""

import pytest
import torch

from acas2d_tpu_torch import ab, policy_ab
from acas2d_tpu_torch.ops import _cuda

FILES = {f: (_cuda.CSRC / f).read_text() for f in policy_ab.FILES}


@pytest.mark.parametrize("variant", sorted(policy_ab.VARIANTS))
def test_variant_edits_apply_to_the_kernel_sources(variant):
    edits = policy_ab.VARIANTS[variant]
    edited = ab.variant_files(FILES, edits)
    assert edited != FILES
    for name, old, new in edits:
        assert old in FILES[name] and new in edited[name]


def test_an_edit_that_matches_nothing_is_refused():
    with pytest.raises(ValueError, match="matches nothing"):
        ab.variant_files(FILES, [("tf32x3.cuh", "no such text", "")])


def test_tool_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert policy_ab.main([]) == 1
