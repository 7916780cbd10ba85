"""Symmetric int8 quantization of the int8 recipes (plain versions).

Port of the quantization helpers of ``audiossl_tpu/ops/pallas_block.py``:

* :func:`quantize_weight_q8` (``:251``): per-channel weight codes and
  scales. As in the JAX package it runs outside the kernels, as plain
  tensor operations, once per call (the EMA teacher's and the student's
  weights change every step).
* :func:`q8_act` (``_q8_act :79``): per-row codes and scales of an f32
  activation, with an optional precomputed bound on each row's magnitude.
* :func:`q8_dot` (``_q8_dot :96``): the int8 x int8 -> int32 product of
  both, dequantized as ``f32(acc) * r[m] * s[n]``.

The kernels K2q-K5q (``csrc/quant_q8.cuh``, ``csrc/gemm_s8.cuh``) run the
same arithmetic inside their launches: codes round half to even and clamp
to [-127, 127]; an activation row is scaled by ``127 / m`` (a multiply),
a weight by ``w / s`` (a divide); both clamp ``m, s >= 1e-30``.

The plain product is exact, as the kernels' int32 accumulator is: the
codes are multiplied in float64, whose 53-bit mantissa holds every sum of
up to 2^38 products of magnitude 127^2 (an f32 sum of int8 products stops
being exact past K = 1,040, and fc2 has K = 3,072), and the exact integer
is rounded once to f32.
"""
from __future__ import annotations

from typing import Optional

import torch

QUANT_MODES = ("int8", "int8dx")  # train_quant; infer_quant takes "int8"


def check_quant(quant: Optional[str], allowed=QUANT_MODES) -> Optional[str]:
    """``quant`` with ``"none"`` read as None; raises on an unknown mode."""
    if quant in (None, "none"):
        return None
    if quant not in allowed:
        raise ValueError(f"unknown quant mode {quant!r} (supported: None, "
                         + ", ".join(repr(q) for q in allowed) + ")")
    return quant


def check_codes(name: str, *codes: torch.Tensor) -> None:
    """What a kernel wrapper checks of int8 weight codes: int8, and every
    width a multiple of 16 (the int8 products load 16 codes at a time)."""
    if any(q.dtype != torch.int8 for q in codes):
        raise ValueError(f"{name}: weights must be int8 codes "
                         "(quantize_weight_q8)")
    if any(n % 16 for q in codes for n in q.shape):
        raise ValueError(f"{name}: weight widths must be multiples of 16, "
                         f"got {[tuple(q.shape) for q in codes]}")


def quantize_weight_q8(w: torch.Tensor, dim: int = 1):
    """Per-channel symmetric int8 codes of a weight: the channels are the
    slices along ``dim`` reduced over. For torch's ``[out, in]`` layout
    ``dim=1`` gives per-output-channel scales (the forward products,
    ``quantize_weight_q8(w)`` of the JAX ``[in, out]`` kernel) and
    ``dim=0`` per-input-channel scales (the grad-to-input products of
    ``int8dx``, ``quantize_weight_q8(w.T)`` there). Returns (int8 codes in
    w's layout, f32 scales [w.shape[1 - dim]])."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=dim) * (1.0 / 127.0), min=1e-30)
    q = torch.clamp(torch.round(wf / s.unsqueeze(dim)), -127.0, 127.0)
    return q.to(torch.int8), s


def dequantize_weight_q8(q: torch.Tensor, s: torch.Tensor, dtype,
                         dim: int = 1) -> torch.Tensor:
    """``dtype(q * s)``: the weights the backward of a quantized forward
    differentiates through (``pallas_attn.py:317-318``)."""
    return (q.float() * s.unsqueeze(dim)).to(dtype)


def q8_act(h: torch.Tensor, bound: Optional[torch.Tensor] = None):
    """Per-row symmetric int8 codes of an f32 activation h [..., K]:
    (int8 codes, f32 scales [..., 1]). ``bound`` [..., 1] is an upper bound
    on each row's magnitude that replaces the row's absmax."""
    m = h.abs().amax(dim=-1, keepdim=True) if bound is None else bound
    m = torch.clamp(m, min=1e-30)
    r = m * (1.0 / 127.0)
    rinv = 127.0 / m
    q = torch.clamp(torch.round(h * rinv), -127.0, 127.0)
    return q.to(torch.int8), r


def int8_matmul(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 product q [..., K] x w [K, J] as f32 (each sum rounded
    once, as the int32 accumulator is converted)."""
    return (q.double() @ w.double()).float()


def q8_dot(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
           bound: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 h [..., K] x per-channel codes wq [K, J] with scales ws [J] ->
    f32 [..., J]: the activation quantized per row, the int8 product, then
    ``f32(acc) * r * ws``."""
    q, r = q8_act(h.float(), bound)
    return int8_matmul(q, wq) * r * ws
