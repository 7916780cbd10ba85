"""Trainable attention residual half of a pre-LN block (kernel K4).

Port of ``audiossl_tpu/ops/pallas_attn.py:283 fused_attn_block``:
``y = x + dp * proj(MHA(qkv(LN1(x))))`` with gradients to x, the LN
parameters and the four projection parameters. The forward
(``csrc/attn_train.cu``) is K2's computation plus the residuals the
backward reads: ``qkv`` [B, N, 3C] and the per-head normalized attention
output ``o`` [B, N, C] in the compute dtype, and the reciprocal softmax
denominators ``r`` [B, N, H] in f32. The backward recomputes
``e = exp(s)`` and follows ``_bwd_impl`` (``pallas_attn.py:123-226``)
rounding for rounding.

Masking is the TPU kernel's (see ``ops/block_infer.py``): invalid keys are
zeroed in k and dropped from the values and the denominator by a validity
column; a sequence with no valid key attends uniformly in the forward,
and invalid keys receive zero dk/dv in the backward.

Weights come in torch's ``[out, in]`` layout in their master dtype (f32)
and are cast to the activations' dtype on every call, as the Pallas
wrappers cast them; gradients are returned in f32. Each wrapper takes its
plain version (``*_ref``, the same math written out, backward included)
for a CPU tensor and launches its kernel for a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.ops.block_infer import _ln, _value_validity
from audiossl_tpu_torch.ops.mha import (exp_attention_bwd_ref,
                                        exp_attention_ref)


def _ln_stats(xf, eps):
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * rstd, rstd


def ln_backward_ref(dh, xhat, rstd, ls, dyf):
    """LayerNorm backward of a residual half: dh at the LN output, xhat and
    rstd from recomputed f32 statistics, dyf the gradient arriving at the
    block output (the residual path). Returns (dx f32, dls, dlb)."""
    red = tuple(range(dh.ndim - 1))
    dls = (dh * xhat).sum(dim=red)
    dlb = dh.sum(dim=red)
    dxh = dh * ls.float()
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    return dyf + rstd * (dxh - m1 - xhat * m2), dls, dlb


def attn_train_fwd_ref(x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj, b_proj,
                       num_heads: int, eps: float = 1e-6):
    """Plain version of :func:`attn_train_fwd`."""
    cdt = x.dtype
    H = num_heads
    d = x.shape[-1] // H
    validf = valid.float()
    xf = x.float()
    h = _ln(xf, ls, lb, eps).to(cdt).float()
    qkv = h @ w_qkv.to(cdt).float().t()
    if b_qkv is not None:
        qkv = qkv + b_qkv.float()
    qkv = qkv.to(cdt)
    o, r = exp_attention_ref(qkv, validf, _value_validity(validf), H,
                             d ** -0.5)
    y = o.float() @ w_proj.to(cdt).float().t() + b_proj.float()
    out = (xf + y * dp.float()[:, None, None]).to(x.dtype)
    return out, qkv, o, r


def attn_train_bwd_ref(x, dy, qkv, o, r, valid, dp, ls, lb, w_qkv, w_proj,
                       num_heads: int, eps: float = 1e-6):
    """Plain version of :func:`attn_train_bwd`: the backward math of
    ``pallas_attn._bwd_impl`` written out, rounding to the compute dtype
    where it rounds (not autograd of the forward)."""
    cdt = x.dtype
    H = num_heads
    xf = x.float()
    xhat, rstd = _ln_stats(xf, eps)
    h = (xhat * ls.float() + lb.float()).to(cdt).float()

    dyf = dy.float()
    dyb = (dyf * dp.float()[:, None, None]).to(cdt).float()
    dw_proj = torch.einsum("bnc,bnk->ck", dyb, o.float())
    db_proj = dyb.sum(dim=(0, 1))
    do = dyb @ w_proj.to(cdt).float()
    dqkv = exp_attention_bwd_ref(qkv, o, r, do, valid, H,
                                 (x.shape[-1] // H) ** -0.5).float()

    dw_qkv = torch.einsum("bnj,bnk->jk", dqkv, h)
    db_qkv = dqkv.sum(dim=(0, 1))
    dh = dqkv @ w_qkv.to(cdt).float()
    dx, dls, dlb = ln_backward_ref(dh, xhat, rstd, ls, dyf)
    return dx.to(x.dtype), dls, dlb, dw_qkv, db_qkv, dw_proj, db_proj


def _check(name, x, num_heads, *f32s):
    B, N, C = x.shape
    d = C // num_heads
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 activations")
    if d * num_heads != C or d not in (32, 64):
        raise ValueError(f"{name}: head dim {C}/{num_heads} must be 32 or 64")
    if C % 32 or B > 65535:
        raise ValueError(f"{name}: width {C} must be a multiple of 32 and "
                         f"the batch ({B}) at most 65535")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError(f"{name}: masks, LN parameters and biases must be "
                         "f32")


def _weights(x, w_qkv, b_qkv, w_proj):
    C = x.shape[-1]
    if tuple(w_qkv.shape) != (3 * C, C) or tuple(w_proj.shape) != (C, C):
        raise ValueError("attn_train: weight shapes do not match C")
    if b_qkv is None:  # qkv_bias=False archs: zeros
        b_qkv = torch.zeros(3 * C, device=x.device, dtype=torch.float32)
    return (w_qkv.to(x.dtype).contiguous(), b_qkv.float().contiguous(),
            w_proj.to(x.dtype).contiguous())


def attn_train_fwd(x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj, b_proj,
                   num_heads: int, eps: float = 1e-6):
    """Forward of the attention half: x [B, N, C]; valid [B, N] 0/1 key
    mask; dp [B] drop-path keep multipliers; ls/lb [C]; w_qkv [3C, C];
    b_qkv [3C] or None; w_proj [C, C]; b_proj [C]. Returns
    (y [B, N, C], qkv [B, N, 3C], o [B, N, C], r [B, N, H] f32)."""
    if x.device.type == "cpu":
        return attn_train_fwd_ref(x, valid, dp, ls, lb, w_qkv, b_qkv,
                                  w_proj, b_proj, num_heads, eps)
    B, N, C = x.shape
    H = num_heads
    wq, bq, wp = _weights(x, w_qkv, b_qkv, w_proj)
    validf = valid.float().contiguous()
    vv = _value_validity(validf)
    dp = dp.float().contiguous()
    _check("attn_train_fwd", x, H, validf, dp, ls, lb, bq, b_proj)
    kb.require_cuda("attn_train_fwd", x, validf, vv, dp, ls, lb, wq, bq, wp,
                    b_proj)
    M = B * N
    dev = x.device
    h = torch.empty(M, C, device=dev, dtype=x.dtype)
    qkv = torch.empty(B, N, 3 * C, device=dev, dtype=x.dtype)
    o = torch.empty(B, N, C, device=dev, dtype=x.dtype)
    r = torch.empty(B, N, H, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    kb.launch("attn_train_fwd", dev, *map(kb.ptr, (
        x, validf, vv, dp, ls, lb, wq, bq, wp, b_proj, out, h, qkv, o, r)),
        B, N, C, H, (C // H) ** -0.5, eps)
    return out, qkv, o, r


def attn_train_bwd(x, dy, qkv, o, r, valid, dp, ls, lb, w_qkv, w_proj,
                   num_heads: int, eps: float = 1e-6):
    """Backward of the attention half from the forward's residuals; dy
    [B, N, C] in x's dtype. Returns (dx, dls, dlb, dw_qkv, db_qkv,
    dw_proj, db_proj), the parameter gradients in f32."""
    if x.device.type == "cpu":
        return attn_train_bwd_ref(x, dy, qkv, o, r, valid, dp, ls, lb,
                                  w_qkv, w_proj, num_heads, eps)
    B, N, C = x.shape
    H = num_heads
    wq, _, wp = _weights(x, w_qkv, None, w_proj)
    validf = valid.float().contiguous()
    dp = dp.float().contiguous()
    _check("attn_train_bwd", x, H, validf, dp, ls, lb, r)
    if dy.dtype != x.dtype or qkv.dtype != x.dtype or o.dtype != x.dtype:
        raise ValueError("attn_train_bwd: dy, qkv and o must be in x's dtype")
    kb.require_cuda("attn_train_bwd", x, dy, qkv, o, r, validf, dp, ls, lb,
                    wq, wp)
    M = B * N
    dev = x.device

    def f32(*shape):
        return torch.empty(*shape, device=dev, dtype=torch.float32)

    def b16(*shape):
        return torch.empty(*shape, device=dev, dtype=torch.bfloat16)

    dx = torch.empty_like(x)
    dw_qkv, db_qkv = f32(3 * C, C), f32(3 * C)
    dw_proj, db_proj, dls, dlb = f32(C, C), f32(C), f32(C), f32(C)
    scratch = (b16(M, C), b16(M, C), b16(M, C), b16(M, 3 * C), f32(M, C),
               f32(M, H))
    kb.launch("attn_train_bwd", dev, *map(kb.ptr, (
        x, dy, qkv, o, r, validf, dp, ls, lb, wq, wp, dx, dw_qkv, db_qkv,
        dw_proj, db_proj, dls, dlb, *scratch)),
        B, N, C, H, (C // H) ** -0.5, eps)
    return dx, dls, dlb, dw_qkv, db_qkv, dw_proj, db_proj


class _AttnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj, b_proj,
                num_heads, eps, plain):
        fwd = attn_train_fwd_ref if plain else attn_train_fwd
        y, qkv, o, r = fwd(x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj,
                           b_proj, num_heads, eps)
        ctx.save_for_backward(x, valid, dp, ls, lb, w_qkv, w_proj, qkv, o, r)
        ctx.cfg = (num_heads, eps, plain, b_qkv is not None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, valid, dp, ls, lb, w_qkv, w_proj, qkv, o, r = ctx.saved_tensors
        num_heads, eps, plain, has_bq = ctx.cfg
        bwd = attn_train_bwd_ref if plain else attn_train_bwd
        dx, dls, dlb, dwq, dbq, dwp, dbp = bwd(
            x, dy.to(x.dtype).contiguous(), qkv, o, r, valid, dp, ls, lb,
            w_qkv, w_proj, num_heads, eps)
        return (dx, None, None, dls.to(ls.dtype), dlb.to(lb.dtype),
                dwq.to(w_qkv.dtype), dbq if has_bq else None,
                dwp.to(w_proj.dtype), dbp, None, None, None)


def fused_attn_block(x, valid, dp, ls, lb, w_qkv, b_qkv: Optional[torch.Tensor],
                     w_proj, b_proj, num_heads: int, eps: float = 1e-6,
                     plain: bool = False):
    """y = x + dp * proj(MHA(qkv(LN(x)))) with gradients to x, ls, lb and
    the projection parameters (not to valid or dp). ``plain=True`` runs
    the plain versions on any device (the reference the kernels are held
    against)."""
    return _AttnTrain.apply(x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj,
                            b_proj, num_heads, eps, plain)
