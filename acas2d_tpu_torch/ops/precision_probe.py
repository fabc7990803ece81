"""Operand-precision probe: does the default float32 product round its
operands to bf16?

Counterpart of `scripts/pallas_tpu_check.py:244` (`_probe_kernel`) and of
the check around it (:210-269).  One (128, 128) x (128, 128) float32
product is computed three ways: `o_def` in the port's default float32
arithmetic, `o_bf` on operands rounded to bf16 with float32 sums (the bf16
update's arithmetic), `o_hi` in float64, rounded at the end (the
counterpart of `Precision.HIGHEST`).  On the input whose every entry is
1 + 2^-12, which bf16 cannot hold, times the identity, `quantizes_operands`
is the JAX script's boolean: the default product equals the bf16 one and
not the exact one.  Where it is true, the bf16 update kernel gives the f32
kernel's gradients bit for bit; where it is false, they differ.

The wrapper launches the CUDA kernel (`csrc/precision_probe.cu`, the
gradient kernel's fused multiply-add loop) for CUDA tensors and runs the
plain version (`_probe_plain`: float32 matmul with TF32 off, bf16-rounded
operands, float64) for CPU tensors.  There is no fallback between the two.
`precision_probe.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.ops import _cuda
from acas2d_tpu_torch.ops.ppo_grads import bf16_round

N = 128


def _probe_plain(a: torch.Tensor, b: torch.Tensor):
    """(o_def, o_bf, o_hi) in torch: float32 matmul without TF32, the same
    on bf16-rounded operands, and float64 rounded to float32."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        o_def = a @ b
        o_bf = bf16_round(a) @ bf16_round(b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    o_hi = (a.double() @ b.double()).to(torch.float32)
    return o_def, o_bf, o_hi


def _probe_cuda(a: torch.Tensor, b: torch.Tensor):
    """Launch csrc/precision_probe.cu; same operands/outputs as _probe_plain."""
    _cuda.require(a, "a", torch.float32, (N, N))
    _cuda.require(b, "b", torch.float32, (N, N))
    lib = _cuda.load("precision_probe")
    fn = lib.acas_precision_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6
    outs = [torch.empty(N, N, dtype=torch.float32, device=a.device)
            for _ in range(3)]
    rc = fn(_cuda.ptr(a), _cuda.ptr(b), *(_cuda.ptr(o) for o in outs),
            _cuda.stream_of(a))
    _cuda.check(rc, lib, "precision_probe launch")
    precision_probe.launches += 1
    return tuple(outs)


def precision_probe(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o_def, o_bf, o_hi) of the (128, 128) product a @ b."""
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    if tuple(a.shape) != (N, N) or tuple(b.shape) != (N, N):
        raise ValueError(f"the probe takes two ({N}, {N}) operands")
    fn = _probe_cuda if a.is_cuda else _probe_plain
    return fn(a, b)


def probe_inputs(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's input (pallas_tpu_check.py:252-254): every entry
    of A is 1 + 2^-12, which bf16 cannot hold; B is the identity."""
    dev = resolve_device(device)
    a = torch.full((N, N), 1.0 + 2.0 ** -12, dtype=torch.float32, device=dev)
    return a, torch.eye(N, dtype=torch.float32, device=dev)


def quantizes_operands(device=None) -> bool:
    """True when the default product rounds its operands to bf16: it equals
    the bf16 product and not the exact one (pallas_tpu_check.py:261-262)."""
    o_def, o_bf, o_hi = precision_probe(*probe_inputs(device))
    return bool(torch.equal(o_def, o_bf) and not torch.equal(o_def, o_hi))


precision_probe.launches = 0
