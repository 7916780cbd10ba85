"""Trainable attention residual half of a pre-LN block (kernels K4, K4q).

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

``quant`` (the student under ``student_quant``) follows
``pallas_attn.py:304-318, 396-408``: ``"int8"`` runs the forward's qkv and
proj products in int8 (K4q forward, :func:`attn_train_fwd_q8`, from the f32
LN output and from ``o`` after its bf16 store) and saves the dequantized
weights ``cdt(q * s)``; its backward is K4's on those weights.
``"int8dx"`` also runs the backward's grad-to-input products ``do`` and
``dh`` in int8 against the transposes of those dequantized weights,
quantized again per input channel (K4q backward,
:func:`attn_train_bwd_q8dx`); the attention core and the weight-gradient
products stay the float kernel's. The weight gradient goes to the master
weight (straight through), rounded to the dequantized weights' dtype as
the JAX package returns it.
"""
from __future__ import annotations

from typing import Optional

import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.ops.block_infer import _ln, _value_validity
from audiossl_tpu_torch.ops.mha import (exp_attention_bwd_ref,
                                        exp_attention_ref)
from audiossl_tpu_torch.ops.quant import (check_codes, check_quant,
                                          dequantize_weight_q8, q8_dot,
                                          quantize_weight_q8)


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


def _fwd(x, valid, dp, ls, lb, dot_qkv, dot_proj, num_heads: int,
         eps: float):
    """The forward shared by the float and int8 plain versions
    (``pallas_attn.py:50 _fwd_body``): ``dot_qkv`` maps the f32 LN output
    and ``dot_proj`` the stored attention output (as f32) to f32 rows, the
    qkv bias included, the proj bias not."""
    cdt = x.dtype
    validf = valid.float()
    xf = x.float()
    qkv = dot_qkv(_ln(xf, ls, lb, eps)).to(cdt)
    o, r = exp_attention_ref(qkv, validf, _value_validity(validf), num_heads,
                             (x.shape[-1] // num_heads) ** -0.5)
    y = dot_proj(o.float())
    return (xf + y * dp.float()[:, None, None]).to(x.dtype), qkv, o, r


def _biased(y, b):
    return y if b is None else y + b.float()


def attn_train_fwd_ref(x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj, b_proj,
                       num_heads: int, eps: float = 1e-6):
    """Plain version of :func:`attn_train_fwd`."""
    cdt = x.dtype
    return _fwd(
        x, valid, dp, ls, lb,
        lambda h: _biased(h.to(cdt).float() @ w_qkv.to(cdt).float().t(),
                          b_qkv),
        lambda o: o @ w_proj.to(cdt).float().t() + b_proj.float(),
        num_heads, eps)


def attn_train_fwd_q8_ref(x, valid, dp, ls, lb, wq_qkv, s_qkv, b_qkv,
                          wq_proj, s_proj, b_proj, num_heads: int,
                          eps: float = 1e-6):
    """Plain version of :func:`attn_train_fwd_q8` (``pallas_attn.py:106
    _fwd_kernel_q8``)."""
    return _fwd(
        x, valid, dp, ls, lb,
        lambda h: _biased(q8_dot(h, wq_qkv.t(), s_qkv), b_qkv),
        lambda o: q8_dot(o, wq_proj.t(), s_proj) + b_proj.float(),
        num_heads, eps)


def _bwd(x, dy, qkv, o, r, valid, dp, ls, lb, dot_do, dot_dh, num_heads: int,
         eps: float):
    """The backward math of ``pallas_attn._bwd_impl`` written out, rounding
    to the compute dtype where it rounds (not autograd of the forward).
    ``dot_do`` maps the f32 ``dy * dp`` and ``dot_dh`` the rounded dqkv (as
    f32) to the f32 grad-to-input rows."""
    cdt = x.dtype
    H = num_heads
    xf = x.float()
    xhat, rstd = _ln_stats(xf, eps)
    h = (xhat * ls.float() + lb.float()).to(cdt).float()

    dyf = dy.float()
    dys = dyf * dp.float()[:, None, None]
    dyb = dys.to(cdt).float()
    dw_proj = torch.einsum("bnc,bnk->ck", dyb, o.float())
    db_proj = dyb.sum(dim=(0, 1))
    do = dot_do(dys)
    dqkv = exp_attention_bwd_ref(qkv, o, r, do, valid, H,
                                 (x.shape[-1] // H) ** -0.5).float()

    dw_qkv = torch.einsum("bnj,bnk->jk", dqkv, h)
    db_qkv = dqkv.sum(dim=(0, 1))
    dh = dot_dh(dqkv)
    dx, dls, dlb = ln_backward_ref(dh, xhat, rstd, ls, dyf)
    return dx.to(x.dtype), dls, dlb, dw_qkv, db_qkv, dw_proj, db_proj


def attn_train_bwd_ref(x, dy, qkv, o, r, valid, dp, ls, lb, w_qkv, w_proj,
                       num_heads: int, eps: float = 1e-6):
    """Plain version of :func:`attn_train_bwd`."""
    cdt = x.dtype
    return _bwd(x, dy, qkv, o, r, valid, dp, ls, lb,
                lambda g: g.to(cdt).float() @ w_proj.to(cdt).float(),
                lambda g: g @ w_qkv.to(cdt).float(), num_heads, eps)


def attn_train_bwd_q8dx_ref(x, dy, qkv, o, r, valid, dp, ls, lb, wt_qkv,
                            st_qkv, wt_proj, st_proj, num_heads: int,
                            eps: float = 1e-6):
    """Plain version of :func:`attn_train_bwd_q8dx` (``pallas_attn.py:252
    _bwd_kernel_q8dx``): wt_qkv [3C, C] / wt_proj [C, C] are the int8 codes
    of the dequantized weights quantized per input channel (scales st_qkv,
    st_proj [C])."""
    return _bwd(x, dy, qkv, o, r, valid, dp, ls, lb,
                lambda g: q8_dot(g, wt_proj, st_proj),
                lambda g: q8_dot(g, wt_qkv, st_qkv), num_heads, eps)


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


def _check_codes(name, C, *codes):
    check_codes(name, *codes)
    if any(tuple(q.shape) != (n, C) for q, n in zip(codes, (3 * C, C))):
        raise ValueError(f"{name}: weight shapes do not match C")


def attn_train_fwd_q8(x, valid, dp, ls, lb, wq_qkv, s_qkv, b_qkv, wq_proj,
                      s_proj, b_proj, num_heads: int, eps: float = 1e-6):
    """K4q forward: :func:`attn_train_fwd` with int8 qkv and proj products;
    wq_qkv [3C, C] / wq_proj [C, C] int8 codes with per-output-channel
    scales s_qkv [3C] / s_proj [C]. Returns (y, qkv, o, r) as
    :func:`attn_train_fwd`."""
    if x.device.type == "cpu":
        return attn_train_fwd_q8_ref(x, valid, dp, ls, lb, wq_qkv, s_qkv,
                                     b_qkv, wq_proj, s_proj, b_proj,
                                     num_heads, eps)
    B, N, C = x.shape
    H = num_heads
    _check_codes("attn_train_fwd_q8", C, wq_qkv, wq_proj)
    if b_qkv is None:
        b_qkv = torch.zeros(3 * C, device=x.device, dtype=torch.float32)
    validf = valid.float().contiguous()
    vv = _value_validity(validf)
    dp = dp.float().contiguous()
    _check("attn_train_fwd_q8", x, H, validf, dp, ls, lb, s_qkv, b_qkv,
           s_proj, b_proj)
    kb.require_cuda("attn_train_fwd_q8", x, validf, vv, dp, ls, lb, wq_qkv,
                    s_qkv, b_qkv, wq_proj, s_proj, b_proj)
    M = B * N
    dev = x.device
    hq = torch.empty(M, C, device=dev, dtype=torch.int8)
    oq = torch.empty(M, C, device=dev, dtype=torch.int8)
    hr = torch.empty(M, device=dev, dtype=torch.float32)
    orr = torch.empty(M, device=dev, dtype=torch.float32)
    qkv = torch.empty(B, N, 3 * C, device=dev, dtype=x.dtype)
    o = torch.empty(B, N, C, device=dev, dtype=x.dtype)
    r = torch.empty(B, N, H, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    kb.launch("attn_train_fwd_q8", dev, *map(kb.ptr, (
        x, validf, vv, dp, ls, lb, wq_qkv, s_qkv, b_qkv, wq_proj, s_proj,
        b_proj, out, hq, hr, qkv, o, r, oq, orr)),
        B, N, C, H, (C // H) ** -0.5, eps)
    return out, qkv, o, r


def attn_train_bwd_q8dx(x, dy, qkv, o, r, valid, dp, ls, lb, wt_qkv, st_qkv,
                        wt_proj, st_proj, num_heads: int, eps: float = 1e-6):
    """K4q backward (``int8dx``): :func:`attn_train_bwd` with the
    grad-to-input products do and dh in int8 against wt_qkv [3C, C] /
    wt_proj [C, C], the int8 codes of the dequantized weights quantized
    per input channel (st_qkv / st_proj [C],
    ``quantize_weight_q8(w, dim=0)``). The kernel's int8 products read
    their weight codes K-major, so it takes those of W_qkv^T [C, 3C] and
    W_proj^T [C, C] (``[in, out]``), copied here from wt_qkv and wt_proj."""
    if x.device.type == "cpu":
        return attn_train_bwd_q8dx_ref(x, dy, qkv, o, r, valid, dp, ls, lb,
                                       wt_qkv, st_qkv, wt_proj, st_proj,
                                       num_heads, eps)
    B, N, C = x.shape
    H = num_heads
    _check_codes("attn_train_bwd_q8dx", C, wt_qkv, wt_proj)
    validf = valid.float().contiguous()
    dp = dp.float().contiguous()
    _check("attn_train_bwd_q8dx", x, H, validf, dp, ls, lb, r, st_qkv,
           st_proj)
    if dy.dtype != x.dtype or qkv.dtype != x.dtype or o.dtype != x.dtype:
        raise ValueError("attn_train_bwd_q8dx: dy, qkv and o must be in x's "
                         "dtype")
    kb.require_cuda("attn_train_bwd_q8dx", x, dy, qkv, o, r, validf, dp, ls,
                    lb, wt_qkv, st_qkv, wt_proj, st_proj)
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
               f32(M, H), torch.empty(M, 3 * C, device=dev, dtype=torch.int8),
               f32(M))
    kb.launch("attn_train_bwd_q8dx", dev, *map(kb.ptr, (
        x, dy, qkv, o, r, validf, dp, ls, lb, wt_qkv.t().contiguous(),
        st_qkv, wt_proj.t().contiguous(), st_proj, dx, dw_qkv, db_qkv,
        dw_proj, db_proj, dls, dlb, *scratch)),
        B, N, C, H, (C // H) ** -0.5, eps)
    return dx, dls, dlb, dw_qkv, db_qkv, dw_proj, db_proj


class _AttnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj, b_proj,
                num_heads, eps, plain, quant):
        if quant:
            qq, sq = quantize_weight_q8(w_qkv)
            qp, sp = quantize_weight_q8(w_proj)
            fwd = attn_train_fwd_q8_ref if plain else attn_train_fwd_q8
            y, qkv, o, r = fwd(x, valid, dp, ls, lb, qq, sq, b_qkv, qp, sp,
                               b_proj, num_heads, eps)
            # the backward differentiates the dequantized-weight function
            w_qkv_s = dequantize_weight_q8(qq, sq, x.dtype)
            w_proj_s = dequantize_weight_q8(qp, sp, x.dtype)
        else:
            fwd = attn_train_fwd_ref if plain else attn_train_fwd
            y, qkv, o, r = fwd(x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj,
                               b_proj, num_heads, eps)
            w_qkv_s, w_proj_s = w_qkv, w_proj
        ctx.save_for_backward(x, valid, dp, ls, lb, w_qkv_s, w_proj_s, qkv, o,
                              r)
        ctx.cfg = (num_heads, eps, plain, quant, b_qkv is not None,
                   w_qkv.dtype, w_proj.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, valid, dp, ls, lb, w_qkv, w_proj, qkv, o, r = ctx.saved_tensors
        num_heads, eps, plain, quant, has_bq, dt_qkv, dt_proj = ctx.cfg
        args = (x, dy.to(x.dtype).contiguous(), qkv, o, r, valid, dp, ls, lb)
        if quant == "int8dx":
            bwd = attn_train_bwd_q8dx_ref if plain else attn_train_bwd_q8dx
            grads = bwd(*args, *quantize_weight_q8(w_qkv, dim=0),
                        *quantize_weight_q8(w_proj, dim=0), num_heads, eps)
        else:
            bwd = attn_train_bwd_ref if plain else attn_train_bwd
            grads = bwd(*args, w_qkv, w_proj, num_heads, eps)
        dx, dls, dlb, dwq, dbq, dwp, dbp = grads
        return (dx, None, None, dls.to(ls.dtype), dlb.to(lb.dtype),
                dwq.to(w_qkv.dtype).to(dt_qkv), dbq if has_bq else None,
                dwp.to(w_proj.dtype).to(dt_proj), dbp, None, None, None, None)


def fused_attn_block(x, valid, dp, ls, lb, w_qkv, b_qkv: Optional[torch.Tensor],
                     w_proj, b_proj, num_heads: int, eps: float = 1e-6,
                     plain: bool = False, quant: Optional[str] = None):
    """y = x + dp * proj(MHA(qkv(LN(x)))) with gradients to x, ls, lb and
    the projection parameters (not to valid or dp). ``quant`` is None,
    ``"int8"`` or ``"int8dx"`` (module docstring). ``plain=True`` runs the
    plain versions on any device (the reference the kernels are held
    against)."""
    return _AttnTrain.apply(x, valid, dp, ls, lb, w_qkv, b_qkv, w_proj,
                            b_proj, num_heads, eps, plain, check_quant(quant))
