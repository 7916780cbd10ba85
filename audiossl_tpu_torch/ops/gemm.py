"""The block kernels' GEMM templates alone, through ``csrc/gemm.cu``: the
bf16 template (``csrc/gemm_bf16.cuh``, :func:`gemm_bf16`) and the int8 one
(``csrc/gemm_s8.cuh``, :func:`gemm_s8`).

No TPU kernel corresponds to these wrappers and no main path calls them:
K2-K5 and K2q-K5q run the templates inside their own launches. They exist
so that each template can be held against a reference at the block
kernels' shapes. :func:`gemm_bf16` takes one operand layout at a time:

- ``"forward"``      a [M, K], b [N, K] -> a b^T (x W^T with torch's
  [out, in] weight);
- ``"dx"``           a [M, K], b [K, N] -> a b (dy W);
- ``"weight_grad"``  a [K, M], b [K, N] -> a^T b (X^T dY over all rows).

and one epilogue at a time: ``"f32"`` (the f32 sums), ``"atomic"`` (the
sums of ``splits`` K ranges added with f32 atomics into a zeroed output;
``splits=0`` with ``"weight_grad"`` takes the block kernels' own split
count) and ``"bias"`` (bf16(sum + bias[n])).

:func:`gemm_s8` takes int8 codes a [M, K] and b [N, K], both K-major, with
f32 scales ra [M] and sb [N]: the dequantized product ``f32(a b^T) * ra[m]
* sb[n]`` of the TPU kernels' ``_q8_dot`` (``"f32"``), or bf16 of it plus
bias[n] (``"bias"``).
"""
from __future__ import annotations

import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.ops.quant import int8_matmul

LAYOUTS = {"forward": 0, "dx": 1, "weight_grad": 2}
EPILOGUES = {"f32": 0, "atomic": 1, "bias": 2}
S8_EPILOGUES = {"f32": 0, "bias": 1}
BK = 64  # the template's K step: each split covers a whole number of them


def _check_operands(name: str, dtype, a: torch.Tensor,
                    b: torch.Tensor) -> None:
    """Raises on operands the templates' TMA loads cannot read: a and b
    must be 2-D ``dtype`` matrices, contiguous at 16-byte aligned
    addresses, their contiguous extent (the row pitch) a multiple of 16
    bytes."""
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"{name}: the operands must be {dtype}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"{name}: the operands must be matrices")
    for t in (a, b):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous and 16-byte aligned")
        if t.shape[1] * t.element_size() % 16:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)}: "
                             "its contiguous extent must be a multiple of "
                             f"{16 // t.element_size()}")


def _check_bias(name: str, epilogue: str, bias, N: int) -> None:
    if epilogue == "bias" and (bias is None or bias.dtype != torch.float32
                               or tuple(bias.shape) != (N,)):
        raise ValueError(f"{name}: the bias epilogue takes an f32 bias of "
                         f"shape ({N},)")


def _check(a: torch.Tensor, b: torch.Tensor, layout: str, epilogue: str,
           bias, splits: int) -> tuple[int, int, int]:
    """(M, N, K) of the product; raises on what the template refuses
    (:func:`_check_operands` for bf16, the layout's shapes, the bias and
    the K splits)."""
    if layout not in LAYOUTS or epilogue not in EPILOGUES:
        raise ValueError(f"gemm_bf16: layout {layout!r} / epilogue "
                         f"{epilogue!r}, expected one of {list(LAYOUTS)} / "
                         f"{list(EPILOGUES)}")
    _check_operands("gemm_bf16", torch.bfloat16, a, b)
    if layout == "forward":
        (M, K), (N, Kb) = a.shape, b.shape
    elif layout == "dx":
        (M, K), (Kb, N) = a.shape, b.shape
    else:
        (K, M), (Kb, N) = a.shape, b.shape
    if K != Kb or min(M, N, K) < 1:
        raise ValueError(f"gemm_bf16 ({layout}): shapes {tuple(a.shape)} "
                         f"and {tuple(b.shape)} do not make a product")
    _check_bias("gemm_bf16", epilogue, bias, N)
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


def _check_s8(a: torch.Tensor, b: torch.Tensor, ra: torch.Tensor,
              sb: torch.Tensor, epilogue: str, bias) -> tuple[int, int, int]:
    """(M, N, K) of the product; raises on what the int8 template refuses:
    int8 codes as :func:`_check_operands` takes them, both K-major (so K
    is a multiple of 16), f32 scales ra [M] and sb [N], and the bias."""
    if epilogue not in S8_EPILOGUES:
        raise ValueError(f"gemm_s8: epilogue {epilogue!r}, expected one of "
                         f"{list(S8_EPILOGUES)}")
    _check_operands("gemm_s8", torch.int8, a, b)
    (M, K), (N, Kb) = a.shape, b.shape
    if K != Kb or min(M, N, K) < 1:
        raise ValueError(f"gemm_s8: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not make a product a b^T")
    for name, sc, n in (("ra", ra, M), ("sb", sb, N)):
        if (sc.dtype != torch.float32 or tuple(sc.shape) != (n,)
                or not sc.is_contiguous()):
            raise ValueError(f"gemm_s8: {name} must be contiguous f32 of "
                             f"shape ({n},)")
    _check_bias("gemm_s8", epilogue, bias, N)
    return M, N, K


def gemm_s8_ref(a: torch.Tensor, b: torch.Tensor, ra: torch.Tensor,
                sb: torch.Tensor, epilogue: str = "f32",
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`gemm_s8`: the exact int8 product rounded
    once to f32, times ra[m], then times sb[n]; ``"bias"`` rounds that
    plus bias[n] to bf16."""
    _check_s8(a, b, ra, sb, epilogue, bias)
    out = int8_matmul(a, b.t()) * ra[:, None] * sb
    return out if epilogue == "f32" else (out + bias).to(torch.bfloat16)


def gemm_s8(a: torch.Tensor, b: torch.Tensor, ra: torch.Tensor,
            sb: torch.Tensor, epilogue: str = "f32",
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """The dequantized int8 product a b^T through the ``epilogue``: f32
    [M, N] for ``"f32"``, bf16 [M, N] for ``"bias"``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    template (or raises). Both check first what the template refuses."""
    M, N, K = _check_s8(a, b, ra, sb, epilogue, bias)
    if all(t.device.type == "cpu" for t in (a, b, ra, sb)):
        return gemm_s8_ref(a, b, ra, sb, epilogue, bias)
    kb.require_cuda("gemm_s8", a, b, ra, sb,
                    *([bias] if bias is not None else []))
    out = torch.empty(M, N, device=a.device,
                      dtype=torch.bfloat16 if epilogue == "bias"
                      else torch.float32)
    kb.call("gemm_s8", a.device, kb.ptr(a), kb.ptr(b), kb.ptr(ra),
            kb.ptr(sb), kb.ptr(out),
            kb.ptr(bias) if bias is not None else None, M, N, K,
            S8_EPILOGUES[epilogue])
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
