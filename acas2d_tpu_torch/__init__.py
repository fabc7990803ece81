"""acas2d_tpu_torch — the PyTorch/CUDA port of the ACAS-2D engine and PPO stack.

Importing the package has no side effects: no device is touched and no kernel
is built.  Entry points run on CUDA unless the caller passes `device="cpu"`
(the tests do); they never fall back to the CPU on their own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA.  Raises if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
