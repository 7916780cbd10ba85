"""The module route's erf-form GELU, forward and backward, one hand-written
kernel each (``csrc/gelu.cu``).

``models/transformer.py:gelu_exact`` is ``0.5 u (1 + erf(u / sqrt 2))``
with the A&S 7.1.26 erf, computed in f32 and returned in u's dtype; its
gradient is the exact derivative ``0.5 (1 + erf(z)) + u exp(-z^2) /
sqrt(2 pi)``, z = u / sqrt 2 (``_ErfApprox``'s ``2/sqrt(pi) exp(-x^2)``),
not the polynomial's. :func:`gelu` computes it with one read of u and one
write of y, and keeps only u for its backward, which reads u and dy and
writes du, in u's dtype. The JAX package leaves this chain to XLA, so the
kernels replace no TPU kernel.

:func:`gelu` takes its plain versions (:func:`gelu_fwd_ref`,
:func:`gelu_bwd_ref`) for a CPU tensor and launches the kernels for any
other, which raise off CUDA.
"""
from __future__ import annotations

import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.models.transformer import erf_approx

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
# elements a launch takes at most: its count is a C int, and a multiple of
# 8 keeps every launch's start 16-byte aligned
CHUNK = 1 << 30


def gelu_fwd_ref(u):
    """Plain version of the forward kernel: the eager chain, which is
    ``gelu_exact`` on the CPU (autograd through ``erf_approx``)."""
    uf = u.float()
    return (0.5 * uf * (1.0 + erf_approx(uf * _INV_SQRT2))).to(u.dtype)


def gelu_bwd_ref(u, dy):
    """Plain version of the backward kernel: du in u's dtype."""
    uf = u.float()
    z = uf * _INV_SQRT2
    d = 0.5 * (1.0 + erf_approx(z)) + uf * _INV_SQRT_2PI * torch.exp(-z * z)
    return (dy.float() * d).to(u.dtype)


def _launch(name, out, *ins):
    """``<name>_launch`` over ``ins`` (contiguous, one dtype) into ``out``,
    a launch per ``CHUNK`` elements."""
    if (out.dtype not in kb.DTYPE_CODES
            or any(t.dtype != out.dtype for t in ins)):
        raise ValueError(f"{name}: tensors must all be f32 or all bf16, got "
                         f"{[t.dtype for t in (*ins, out)]}")
    kb.require_cuda(name, *ins, out)
    flat = [t.view(-1) for t in (*ins, out)]
    n = out.numel()
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        kb.launch(name, out.device, *(kb.ptr(t[s:e]) for t in flat), e - s,
                  kb.DTYPE_CODES[out.dtype])
    return out


def gelu_fwd(u):
    """GELU of u (f32 or bf16, any shape) in u's dtype."""
    if u.device.type == "cpu":
        return gelu_fwd_ref(u)
    u = u.contiguous()
    return _launch("gelu_fwd", torch.empty_like(u), u)


def gelu_bwd(u, dy):
    """The gradient to u of GELU given dy, both of u's shape and dtype."""
    if u.device.type == "cpu":
        return gelu_bwd_ref(u, dy)
    u, dy = u.contiguous(), dy.contiguous()
    return _launch("gelu_bwd", torch.empty_like(u), u, dy)


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return gelu_fwd(u)

    @staticmethod
    def backward(ctx, dy):
        u, = ctx.saved_tensors
        return gelu_bwd(u, dy)


def gelu(u: torch.Tensor) -> torch.Tensor:
    """Erf-form GELU of u in u's dtype, with its gradient; autograd keeps u
    alone."""
    return _Gelu.apply(u)
