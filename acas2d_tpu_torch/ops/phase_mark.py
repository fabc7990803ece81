"""Phase marks on the card: `mark(name, device)` launches the empty
one-thread kernel `phase_mark_<name>` (`csrc/phase_mark.cu`) in the
device's current stream, so that a training iteration captured as a CUDA
graph carries its phase boundaries into every replay and the device trace
can time the phases between them.  `MARKS` are the boundaries, in an
iteration's order.  There is no plain version: on the CPU the iteration's
phases are host spans (`ppo/learner.phase_marks`).  The marks' library is
built alone (`nvcc`), so a path that launches no other kernel of the
package builds none of them."""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from acas2d_tpu_torch.ops import _cuda

MARKS = ("start", "rollout", "gae", "update")
KERNEL = "phase_mark_"             # a mark's kernel is KERNEL + its name

_FNS: Dict[str, Callable] = {}


def mark(name: str, device: torch.device) -> None:
    """Launch mark `name` (one of MARKS) in `device`'s current stream."""
    fn = _FNS.get(name)
    if fn is None:
        if name not in MARKS:
            raise ValueError(f"no phase mark {name!r}; the marks are {MARKS}")
        _cuda.build(("phase_mark",))
        fn = getattr(_cuda.load("phase_mark"), f"acas_phase_mark_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
        _FNS[name] = fn
    rc = fn(ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _cuda.check(rc, _cuda.load("phase_mark"), f"phase mark {name}")
