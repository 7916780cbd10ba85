"""The block kernels' bf16 GEMM template alone (``csrc/gemm_bf16.cuh``
through ``csrc/gemm.cu``).

No TPU kernel corresponds to this wrapper and no main path calls it: K2-K5
run the template inside their own launches. It exists so that the template
can be held against a reference at the block kernels' shapes, one operand
layout at a time:

- ``"forward"``      a [M, K], b [N, K] -> a b^T (x W^T with torch's
  [out, in] weight);
- ``"dx"``           a [M, K], b [K, N] -> a b (dy W);
- ``"weight_grad"``  a [K, M], b [K, N] -> a^T b (X^T dY over all rows).

and one epilogue at a time: ``"f32"`` (the f32 sums), ``"atomic"`` (the
sums of ``splits`` K ranges added with f32 atomics into a zeroed output;
``splits=0`` with ``"weight_grad"`` takes the block kernels' own split
count) and ``"bias"`` (bf16(sum + bias[n])).
"""
from __future__ import annotations

import torch

from audiossl_tpu_torch.kernels import build as kb

LAYOUTS = {"forward": 0, "dx": 1, "weight_grad": 2}
EPILOGUES = {"f32": 0, "atomic": 1, "bias": 2}
BK = 64  # the template's K step: each split covers a whole number of them


def _check(a: torch.Tensor, b: torch.Tensor, layout: str, epilogue: str,
           bias, splits: int) -> tuple[int, int, int]:
    """(M, N, K) of the product; raises on what the template refuses: bf16
    2-D contiguous operands at 16-byte aligned addresses whose contiguous
    extent (the TMA row pitch) is a multiple of 8."""
    if layout not in LAYOUTS or epilogue not in EPILOGUES:
        raise ValueError(f"gemm_bf16: layout {layout!r} / epilogue "
                         f"{epilogue!r}, expected one of {list(LAYOUTS)} / "
                         f"{list(EPILOGUES)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError("gemm_bf16: the operands must be bf16")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("gemm_bf16: the operands must be matrices")
    for t in (a, b):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"gemm_bf16: operand of shape {tuple(t.shape)} "
                             "is not contiguous and 16-byte aligned")
        if t.shape[1] % 8:
            raise ValueError(f"gemm_bf16: operand of shape {tuple(t.shape)}:"
                             " its contiguous extent must be a multiple of 8")
    if layout == "forward":
        (M, K), (N, Kb) = a.shape, b.shape
    elif layout == "dx":
        (M, K), (Kb, N) = a.shape, b.shape
    else:
        (K, M), (Kb, N) = a.shape, b.shape
    if K != Kb or min(M, N, K) < 1:
        raise ValueError(f"gemm_bf16 ({layout}): shapes {tuple(a.shape)} "
                         f"and {tuple(b.shape)} do not make a product")
    if epilogue == "bias" and (bias is None or bias.dtype != torch.float32
                               or tuple(bias.shape) != (N,)):
        raise ValueError(f"gemm_bf16: the bias epilogue takes an f32 bias "
                         f"of shape ({N},)")
    if splits < 0 or (splits == 0 and (epilogue, layout)
                      != ("atomic", "weight_grad")) or (
            splits > 1 and epilogue != "atomic"):
        raise ValueError(f"gemm_bf16: {splits} K splits with the "
                         f"{epilogue!r} epilogue and the {layout!r} layout")
    return M, N, K


def gemm_bf16_ref(a: torch.Tensor, b: torch.Tensor, layout: str,
                  epilogue: str = "f32", bias: torch.Tensor | None = None,
                  splits: int = 1) -> torch.Tensor:
    """Plain version of :func:`gemm_bf16`: the bf16 operands' products
    summed in f32 by ``torch.matmul``; ``"atomic"`` adds the partial sums
    of the K splits (``splits=0``: one), ``"bias"`` rounds sum + bias to
    bf16."""
    _, N, K = _check(a, b, layout, epilogue, bias, splits)
    lhs, rhs = a.float(), b.float()
    if layout == "forward":
        rhs = rhs.t()
    elif layout == "weight_grad":
        lhs = lhs.t()
    if epilogue == "bias":
        return (lhs @ rhs + bias).to(torch.bfloat16)
    if epilogue == "f32":
        return lhs @ rhs
    per = -(-K // max(splits, 1))
    k_split = -(-per // BK) * BK  # whole K steps, as the template splits
    out = torch.zeros(lhs.shape[0], N, dtype=torch.float32, device=a.device)
    for k0 in range(0, K, k_split):
        out += lhs[:, k0:k0 + k_split] @ rhs[k0:k0 + k_split]
    return out


def gemm_bf16(a: torch.Tensor, b: torch.Tensor, layout: str,
              epilogue: str = "f32", bias: torch.Tensor | None = None,
              splits: int = 1) -> torch.Tensor:
    """The product of ``layout`` through the ``epilogue``: f32 [M, N] for
    ``"f32"`` and ``"atomic"``, bf16 [M, N] for ``"bias"``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    template (or raises). Both check first what the template refuses."""
    M, N, K = _check(a, b, layout, epilogue, bias, splits)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_bf16_ref(a, b, layout, epilogue, bias, splits)
    kb.require_cuda("gemm_bf16", a, b, *([bias] if bias is not None else []))
    if epilogue == "atomic":
        out = torch.zeros(M, N, dtype=torch.float32, device=a.device)
    else:
        out = torch.empty(M, N, device=a.device,
                          dtype=torch.bfloat16 if epilogue == "bias"
                          else torch.float32)
    kb.call("gemm_bf16", a.device, kb.ptr(a), kb.ptr(b), kb.ptr(out),
            kb.ptr(bias) if bias is not None else None, M, N, K,
            LAYOUTS[layout], EPILOGUES[epilogue], splits)
    return out


def reciprocal_mismatches(device) -> int:
    """The count of floats x in [1, 2^126] and +inf where the epilogues'
    branch-free reciprocal (``csrc/common.cuh`` ``rcp_ge1``, used by the
    GELU epilogues) differs from the IEEE ``1.0f / x``, computed on the
    card; 0 means the two agree bit for bit over the whole domain."""
    dev = kb.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("reciprocal_mismatches: the check runs on the card")
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    kb.call("rcp_check", dev, kb.ptr(out))
    return int(out.item())
