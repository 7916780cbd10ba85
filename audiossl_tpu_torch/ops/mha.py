"""Standalone multi-head attention on the packed qkv projection (kernel K6).

Port of ``audiossl_tpu/ops/pallas_mha.py:196 fused_mha``: the attention of
an ``Attention`` module whose encoder runs neither block kernel (an f32
encoder with ``fused_attention``), from the packed ``[B, N, 3C]`` qkv
projection (head-major within each C block, the ``reshape(B, N, 3, H, d)``
order) and an additive ``[B, N]`` key mask (0 / -10000, turned into
validity by ``mask > -1``) to ``[B, N, C]`` in qkv's dtype, with a
gradient to qkv.

The math is the exp-only attention of the block kernels (no max
subtraction; invalid keys zeroed in k and dropped from the values and the
denominator by a validity column; the reciprocal denominators ``r``
[B, N, H] f32 saved for the backward), and its kernels are theirs,
templated on the element type (``csrc/mha.cu``). One difference: a
sequence with no valid key gets ``o = 0`` and zero gradients here (its
denominator is 0 and r = 1e30), where the block kernels K2/K4 attend
uniformly over its keys. Invalid keys are excluded exactly, so the TPU
kernel's padding of N to a multiple of 128 is dropped with no effect on any
row. Rounding points, in the element type: e = exp(s), o, and in the
backward delta's products, ``do * r``, ``-delta * r``, ``t = e * dpd`` and
dqkv; products accumulate in f32 (in f32: forward and backward as 3xTF32
on the tensor cores, ~1e-6 relative; never one TF32 pass).

:func:`exp_attention_ref` and :func:`exp_attention_bwd_ref` are the plain
versions of the shared attention core (K4's plain versions use them too);
:func:`mha_fwd` and :func:`mha_bwd` take them for a CPU tensor and launch
the kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch

from audiossl_tpu_torch.kernels import build as kb

MAX_SEQ = 1536  # the TPU kernel's bound (pallas_mha.py:60), kept in both


def _split_heads(qkv, num_heads):
    B, N, C3 = qkv.shape
    return qkv.float().reshape(B, N, 3, num_heads, C3 // 3 // num_heads
                               ).unbind(2)  # q, k, v [B, N, H, d]


def exp_attention_ref(qkv, valid_k, valid_v, num_heads: int, scale: float):
    """Exp-only attention of the packed qkv [B, N, 3C] (in the compute
    dtype) with key validity valid_k [B, N] and value validity valid_v
    (K2/K4: all ones for a sequence with no valid key; K6: valid_k).
    Returns (o [B, N, C] in qkv's dtype, r [B, N, H] f32)."""
    B, N, C3 = qkv.shape
    cdt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    vk = valid_k.float()
    vv = valid_v.float()
    kz = k * vk[:, :, None, None]
    s = torch.einsum("bnhd,bmhd->bhnm", q, kz) * scale
    e = torch.exp(s).to(cdt).float()  # exp-only softmax numerator
    o = torch.einsum("bhnm,bmhd->bnhd", e, v * vv[:, :, None, None])
    r = 1.0 / (torch.einsum("bhnm,bm->bnh", e, vv) + 1e-30)
    return (o * r[..., None]).to(cdt).reshape(B, N, C3 // 3), r


def exp_attention_bwd_ref(qkv, o, r, do, valid, num_heads: int,
                          scale: float):
    """Backward of :func:`exp_attention_ref` to qkv, rounding to qkv's
    dtype where the TPU kernels round (``pallas_mha.py:_bwd_head``,
    ``pallas_attn.py:_bwd_impl``): do [B, N, C] (any float dtype), o and r
    the forward's. Invalid keys get zero dk/dv. Returns dqkv [B, N, 3C] in
    qkv's dtype."""
    B, N, C3 = qkv.shape
    cdt = qkv.dtype
    H = num_heads
    d = C3 // 3 // H
    vk = valid.float()[:, :, None, None]  # [B, N, 1, 1]
    q, k, v = _split_heads(qkv, H)
    kz = k * vk
    vz = v * vk
    og = o.float().reshape(B, N, H, d)
    dog = do.float().reshape(B, N, H, d)
    rr = r.float()[..., None]  # [B, N, H, 1]
    e = torch.exp(torch.einsum("bnhd,bmhd->bhnm", q, kz) * scale)
    e = e.to(cdt).float()
    delta = (dog * og).to(cdt).float().sum(dim=-1, keepdim=True)
    dor = (dog * rr).to(cdt).float()
    nd = (-delta * rr).to(cdt).float()  # [B, N, H, 1]
    dpd = (torch.einsum("bnhd,bmhd->bhnm", dor, vz)
           + nd.squeeze(-1).permute(0, 2, 1)[..., None])
    t = (e * dpd).to(cdt).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", t, kz) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", t, q) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", e, dor)
    return torch.stack([dq.to(cdt), (dk * vk).to(cdt), (dv * vk).to(cdt)],
                       dim=2).reshape(B, N, C3)


def mha_fwd_ref(qkv, valid, num_heads: int, scale: float):
    """Plain version of :func:`mha_fwd`."""
    return exp_attention_ref(qkv, valid, valid, num_heads, scale)


def mha_bwd_ref(qkv, valid, out, r, g, num_heads: int, scale: float):
    """Plain version of :func:`mha_bwd`."""
    return exp_attention_bwd_ref(qkv, out, r, g, valid, num_heads, scale)


def _check(name, qkv, num_heads):
    B, N, C3 = qkv.shape
    C = C3 // 3
    if qkv.dtype not in kb.DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes f32 or bf16, got "
                         f"{qkv.dtype}")
    if C3 % 3 or C % num_heads or C // num_heads not in (32, 64):
        raise ValueError(f"{name}: head dim of {C3} // 3 / {num_heads} must "
                         "be 32 or 64")
    if B > 65535:
        raise ValueError(f"{name}: {B} sequences, at most 65535")


def mha_fwd(qkv, valid, num_heads: int, scale: float):
    """qkv [B, N, 3C] f32 or bf16; valid [B, N] 0/1 key validity. Returns
    (out [B, N, C] in qkv's dtype, r [B, N, H] f32)."""
    if qkv.device.type == "cpu":
        return mha_fwd_ref(qkv, valid, num_heads, scale)
    _check("mha_fwd", qkv, num_heads)
    B, N, C3 = qkv.shape
    validf = valid.float().contiguous()
    kb.require_cuda("mha_fwd", qkv, validf)
    out = torch.empty(B, N, C3 // 3, device=qkv.device, dtype=qkv.dtype)
    r = torch.empty(B, N, num_heads, device=qkv.device, dtype=torch.float32)
    kb.launch("mha_fwd", qkv.device, *map(kb.ptr, (qkv, validf, out, r)),
              kb.DTYPE_CODES[qkv.dtype], B, N, C3 // 3, num_heads, scale)
    return out, r


def mha_bwd(qkv, valid, out, r, g, num_heads: int, scale: float):
    """Gradient to qkv from the forward's out and r and the gradient g of
    out (all but r in qkv's dtype). Returns dqkv [B, N, 3C]."""
    if qkv.device.type == "cpu":
        return mha_bwd_ref(qkv, valid, out, r, g, num_heads, scale)
    _check("mha_bwd", qkv, num_heads)
    if out.dtype != qkv.dtype or g.dtype != qkv.dtype or r.dtype != torch.float32:
        raise ValueError("mha_bwd: out and g must be in qkv's dtype, r f32")
    B, N, C3 = qkv.shape
    validf = valid.float().contiguous()
    kb.require_cuda("mha_bwd", qkv, validf, out, r, g)
    dqkv = torch.empty_like(qkv)
    dor = torch.empty_like(out)
    nd = torch.empty_like(r)
    kb.launch("mha_bwd", qkv.device, *map(kb.ptr, (
        qkv, validf, out, r, g, dqkv, dor, nd)),
        kb.DTYPE_CODES[qkv.dtype], B, N, C3 // 3, num_heads, scale)
    return dqkv


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask, num_heads, scale, plain):
        valid = (mask > -1.0).float()
        fwd = mha_fwd_ref if plain else mha_fwd
        out, r = fwd(qkv, valid, num_heads, scale)
        ctx.save_for_backward(qkv, valid, out, r)
        ctx.cfg = (num_heads, scale, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, valid, out, r = ctx.saved_tensors
        num_heads, scale, plain = ctx.cfg
        bwd = mha_bwd_ref if plain else mha_bwd
        dqkv = bwd(qkv, valid, out, r, g.to(qkv.dtype).contiguous(),
                   num_heads, scale)
        return dqkv, None, None, None, None


def fused_mha(qkv, mask, num_heads: int, scale: float, plain: bool = False):
    """qkv [B, N, 3C] packed q|k|v projections; mask [B, N] additive key
    mask (0 or -10000). Returns [B, N, C] in qkv's dtype, with a gradient
    to qkv. ``plain=True`` runs the plain versions on any device."""
    if qkv.shape[1] > MAX_SEQ:
        raise ValueError(f"fused_mha: N={qkv.shape[1]} > {MAX_SEQ}")
    return _FusedMHA.apply(qkv.contiguous(), mask, num_heads, scale, plain)
