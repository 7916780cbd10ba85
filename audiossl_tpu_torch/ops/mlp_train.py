"""Trainable MLP residual half of a pre-LN block (kernels K5, K5q).

Port of ``audiossl_tpu/ops/pallas_mlp.py:255 fused_mlp_block``:
``y = x + dp * fc2(gelu(fc1(LN2(x))))`` with gradients to x, the LN
parameters and fc1/fc2. The forward (``csrc/mlp_train.cu``) is K3's
computation plus the saved fc1 pre-activation ``u`` [B, N, 4C] in the
compute dtype; the backward rebuilds ``gelu(u)`` and ``gelu'(u)`` from one
shared ``exp(-u^2/2)`` (A&S erf, exact reciprocal) and follows
``_bwd_impl`` (``pallas_mlp.py:147-201``) rounding for rounding.

Weights come in torch's ``[out, in]`` layout in their master dtype and are
cast to the activations' dtype on every call; gradients are f32. Each
wrapper takes its plain version (``*_ref``) for a CPU tensor and launches
its kernel for a CUDA tensor.

``quant`` follows ``pallas_mlp.py:277-290, 350-362`` as
``ops/attn_train.py`` does for the attention half: ``"int8"`` runs fc1 and
fc2 in int8 (K5q forward, :func:`mlp_train_fwd_q8`: fc1 from the f32 LN
output, fc2 from the f32 GELU output quantized with the bound
``max(gelu(rowmax(u)), 0.17)``; the saved u is the quantized path's, in
the compute dtype) and the backward is K5's on the dequantized weights;
``"int8dx"`` also runs ``da`` (from the f32 ``dy * dp``) and ``dh`` (from
the unrounded f32 ``du``) in int8 against the transposed dequantized
weights, quantized per input channel (K5q backward,
:func:`mlp_train_bwd_q8dx`).
"""
from __future__ import annotations

import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.ops.attn_train import _ln_stats, ln_backward_ref
from audiossl_tpu_torch.ops.block_infer import _ln, gelu_bound
from audiossl_tpu_torch.ops.quant import (check_codes, check_quant,
                                          dequantize_weight_q8, q8_dot,
                                          quantize_weight_q8)

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _half_cdf(u, ex2):
    """0.5 * (1 + erf(u / sqrt 2)) by A&S 7.1.26 from exp(-u^2/2)."""
    x = u * _INV_SQRT2
    t = 1.0 / (1.0 + 0.3275911 * x.abs())
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return 0.5 * (1.0 + torch.sign(x) * (1.0 - poly * ex2))


def mlp_train_fwd_ref(x, dp, ls, lb, w1, b1, w2, b2, eps: float = 1e-6):
    """Plain version of :func:`mlp_train_fwd`."""
    cdt = x.dtype
    xf = x.float()
    h = _ln(xf, ls, lb, eps).to(cdt).float()
    u = h @ w1.to(cdt).float().t() + b1.float()
    a = (u * _half_cdf(u, torch.exp(-u * u * 0.5))).to(cdt).float()
    y = a @ w2.to(cdt).float().t() + b2.float()
    return (xf + y * dp.float()[:, None, None]).to(x.dtype), u.to(cdt)


def mlp_train_fwd_q8_ref(x, dp, ls, lb, w1q, s1, b1, w2q, s2, b2,
                         eps: float = 1e-6):
    """Plain version of :func:`mlp_train_fwd_q8` (``pallas_mlp.py:120
    _fwd_kernel_q8``)."""
    xf = x.float()
    u = q8_dot(_ln(xf, ls, lb, eps), w1q.t(), s1) + b1.float()
    a = u * _half_cdf(u, torch.exp(-u * u * 0.5))
    y = q8_dot(a, w2q.t(), s2, bound=gelu_bound(u)) + b2.float()
    return (xf + y * dp.float()[:, None, None]).to(x.dtype), u.to(x.dtype)


def _bwd(x, dy, u, dp, ls, lb, dot_da, dot_dh, eps: float):
    """``pallas_mlp._bwd_impl`` written out, rounding where it rounds.
    ``dot_da`` maps the f32 ``dy * dp`` and ``dot_dh`` the f32 du to the
    f32 grad-to-input rows."""
    cdt = x.dtype
    xf = x.float()
    xhat, rstd = _ln_stats(xf, eps)
    h = (xhat * ls.float() + lb.float()).to(cdt).float()
    uf = u.float()
    ex2 = torch.exp(-uf * uf * 0.5)
    hc = _half_cdf(uf, ex2)
    a = (uf * hc).to(cdt).float()
    gp = hc + uf * _INV_SQRT_2PI * ex2
    dyf = dy.float()
    dyb = dyf * dp.float()[:, None, None]
    dyb_c = dyb.to(cdt).float()
    dw2 = torch.einsum("bnc,bnj->cj", dyb_c, a)
    db2 = dyb.sum(dim=(0, 1))
    du = dot_da(dyb) * gp
    du_c = du.to(cdt).float()
    dw1 = torch.einsum("bnj,bnk->jk", du_c, h)
    db1 = du.sum(dim=(0, 1))
    dh = dot_dh(du)
    dx, dls, dlb = ln_backward_ref(dh, xhat, rstd, ls, dyf)
    return dx.to(x.dtype), dls, dlb, dw1, db1, dw2, db2


def mlp_train_bwd_ref(x, dy, u, dp, ls, lb, w1, w2, eps: float = 1e-6):
    """Plain version of :func:`mlp_train_bwd`."""
    cdt = x.dtype
    return _bwd(x, dy, u, dp, ls, lb,
                lambda g: g.to(cdt).float() @ w2.to(cdt).float(),
                lambda g: g.to(cdt).float() @ w1.to(cdt).float(), eps)


def mlp_train_bwd_q8dx_ref(x, dy, u, dp, ls, lb, wt1, st1, wt2, st2,
                           eps: float = 1e-6):
    """Plain version of :func:`mlp_train_bwd_q8dx` (``pallas_mlp.py:225
    _bwd_kernel_q8dx``): wt1 [Hd, C] / wt2 [C, Hd] are the int8 codes of the
    dequantized weights quantized per input channel (st1 [C], st2 [Hd])."""
    return _bwd(x, dy, u, dp, ls, lb, lambda g: q8_dot(g, wt2, st2),
                lambda g: q8_dot(g, wt1, st1), eps)


def _check(name, x, w1, w2, *f32s):
    B, N, C = x.shape
    Hd = w1.shape[0]
    if tuple(w1.shape) != (Hd, C) or tuple(w2.shape) != (C, Hd):
        raise ValueError(f"{name}: weight shapes do not match C")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 activations")
    if C % 32 or Hd % 32:
        raise ValueError(f"{name}: widths {C}, {Hd} must be multiples of 32")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError(f"{name}: drop-path, LN parameters and biases must "
                         "be f32")


def mlp_train_fwd(x, dp, ls, lb, w1, b1, w2, b2, eps: float = 1e-6):
    """Forward of the MLP half: x [B, N, C]; dp [B]; ls/lb [C]; w1 [Hd, C];
    b1 [Hd]; w2 [C, Hd]; b2 [C]. Returns (y [B, N, C], u [B, N, Hd])."""
    if x.device.type == "cpu":
        return mlp_train_fwd_ref(x, dp, ls, lb, w1, b1, w2, b2, eps)
    B, N, C = x.shape
    Hd = w1.shape[0]
    dp = dp.float().contiguous()
    _check("mlp_train_fwd", x, w1, w2, dp, ls, lb, b1, b2)
    w1c, w2c = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    kb.require_cuda("mlp_train_fwd", x, dp, ls, lb, w1c, b1, w2c, b2)
    dev = x.device
    h = torch.empty(B * N, C, device=dev, dtype=x.dtype)
    u = torch.empty(B, N, Hd, device=dev, dtype=x.dtype)
    a = torch.empty(B * N, Hd, device=dev, dtype=x.dtype)
    out = torch.empty_like(x)
    kb.launch("mlp_train_fwd", dev, *map(kb.ptr, (
        x, dp, ls, lb, w1c, b1, w2c, b2, out, h, u, a)), B, N, C, Hd, eps)
    return out, u


def mlp_train_bwd(x, dy, u, dp, ls, lb, w1, w2, eps: float = 1e-6):
    """Backward of the MLP half from the saved pre-activation; dy in x's
    dtype. Returns (dx, dls, dlb, dw1, db1, dw2, db2), the parameter
    gradients in f32."""
    if x.device.type == "cpu":
        return mlp_train_bwd_ref(x, dy, u, dp, ls, lb, w1, w2, eps)
    B, N, C = x.shape
    Hd = w1.shape[0]
    dp = dp.float().contiguous()
    _check("mlp_train_bwd", x, w1, w2, dp, ls, lb)
    if dy.dtype != x.dtype or u.dtype != x.dtype:
        raise ValueError("mlp_train_bwd: dy and u must be in x's dtype")
    w1c, w2c = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    kb.require_cuda("mlp_train_bwd", x, dy, u, dp, ls, lb, w1c, w2c)
    M = B * N
    dev = x.device

    def f32(*shape):
        return torch.empty(*shape, device=dev, dtype=torch.float32)

    def b16(*shape):
        return torch.empty(*shape, device=dev, dtype=torch.bfloat16)

    dx = torch.empty_like(x)
    dw1, db1, dw2 = f32(Hd, C), f32(Hd), f32(C, Hd)
    db2, dls, dlb = f32(C), f32(C), f32(C)
    scratch = (b16(M, C), b16(M, C), b16(M, Hd), b16(M, Hd), f32(M, C))
    kb.launch("mlp_train_bwd", dev, *map(kb.ptr, (
        x, dy, u, dp, ls, lb, w1c, w2c, dx, dw1, db1, dw2, db2, dls, dlb,
        *scratch)), B, N, C, Hd, eps)
    return dx, dls, dlb, dw1, db1, dw2, db2


def mlp_train_fwd_q8(x, dp, ls, lb, w1q, s1, b1, w2q, s2, b2,
                     eps: float = 1e-6):
    """K5q forward: :func:`mlp_train_fwd` with int8 fc1 and fc2 products;
    w1q [Hd, C] / w2q [C, Hd] int8 codes with per-output-channel scales
    s1 [Hd] / s2 [C]. Returns (y, u) as :func:`mlp_train_fwd`."""
    if x.device.type == "cpu":
        return mlp_train_fwd_q8_ref(x, dp, ls, lb, w1q, s1, b1, w2q, s2, b2,
                                    eps)
    B, N, C = x.shape
    Hd = w1q.shape[0]
    dp = dp.float().contiguous()
    check_codes("mlp_train_fwd_q8", w1q, w2q)
    _check("mlp_train_fwd_q8", x, w1q, w2q, dp, ls, lb, s1, b1, s2, b2)
    kb.require_cuda("mlp_train_fwd_q8", x, dp, ls, lb, w1q, s1, b1, w2q, s2,
                    b2)
    M = B * N
    dev = x.device
    hq = torch.empty(M, C, device=dev, dtype=torch.int8)
    aq = torch.empty(M, Hd, device=dev, dtype=torch.int8)
    hr = torch.empty(M, device=dev, dtype=torch.float32)
    ar = torch.empty(M, device=dev, dtype=torch.float32)
    uf = torch.empty(M, Hd, device=dev, dtype=torch.float32)
    u = torch.empty(B, N, Hd, device=dev, dtype=x.dtype)
    out = torch.empty_like(x)
    kb.launch("mlp_train_fwd_q8", dev, *map(kb.ptr, (
        x, dp, ls, lb, w1q, s1, b1, w2q, s2, b2, out, hq, hr, u, uf, aq, ar)),
        B, N, C, Hd, eps)
    return out, u


def mlp_train_bwd_q8dx(x, dy, u, dp, ls, lb, wt1, st1, wt2, st2,
                       eps: float = 1e-6):
    """K5q backward (``int8dx``): :func:`mlp_train_bwd` with da and dh in
    int8 against wt1 [Hd, C] / wt2 [C, Hd], the int8 codes of the
    dequantized weights quantized per input channel (st1 [C], st2 [Hd],
    ``quantize_weight_q8(w, dim=0)``). The kernel's int8 products read
    their weight codes K-major, so it takes those of W1^T [C, Hd] and W2^T
    [Hd, C] (``[in, out]``), copied here from wt1 and wt2."""
    if x.device.type == "cpu":
        return mlp_train_bwd_q8dx_ref(x, dy, u, dp, ls, lb, wt1, st1, wt2,
                                      st2, eps)
    B, N, C = x.shape
    Hd = wt1.shape[0]
    dp = dp.float().contiguous()
    check_codes("mlp_train_bwd_q8dx", wt1, wt2)
    _check("mlp_train_bwd_q8dx", x, wt1, wt2, dp, ls, lb, st1, st2)
    if dy.dtype != x.dtype or u.dtype != x.dtype:
        raise ValueError("mlp_train_bwd_q8dx: dy and u must be in x's dtype")
    kb.require_cuda("mlp_train_bwd_q8dx", x, dy, u, dp, ls, lb, wt1, st1,
                    wt2, st2)
    M = B * N
    dev = x.device

    def f32(*shape):
        return torch.empty(*shape, device=dev, dtype=torch.float32)

    def b16(*shape):
        return torch.empty(*shape, device=dev, dtype=torch.bfloat16)

    dx = torch.empty_like(x)
    dw1, db1, dw2 = f32(Hd, C), f32(Hd), f32(C, Hd)
    db2, dls, dlb = f32(C), f32(C), f32(C)
    scratch = (b16(M, C), b16(M, C), b16(M, Hd), b16(M, Hd), f32(M, Hd),
               f32(M, C), torch.empty(M, Hd, device=dev, dtype=torch.int8),
               f32(M))
    kb.launch("mlp_train_bwd_q8dx", dev, *map(kb.ptr, (
        x, dy, u, dp, ls, lb, wt1.t().contiguous(), st1,
        wt2.t().contiguous(), st2, dx, dw1, db1, dw2, db2, dls, dlb,
        *scratch)), B, N, C, Hd, eps)
    return dx, dls, dlb, dw1, db1, dw2, db2


class _MlpTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp, ls, lb, w1, b1, w2, b2, eps, plain, quant):
        if quant:
            q1, s1 = quantize_weight_q8(w1)
            q2, s2 = quantize_weight_q8(w2)
            fwd = mlp_train_fwd_q8_ref if plain else mlp_train_fwd_q8
            y, u = fwd(x, dp, ls, lb, q1, s1, b1, q2, s2, b2, eps)
            # the backward differentiates the dequantized-weight function
            w1_s = dequantize_weight_q8(q1, s1, x.dtype)
            w2_s = dequantize_weight_q8(q2, s2, x.dtype)
        else:
            fwd = mlp_train_fwd_ref if plain else mlp_train_fwd
            y, u = fwd(x, dp, ls, lb, w1, b1, w2, b2, eps)
            w1_s, w2_s = w1, w2
        ctx.save_for_backward(x, dp, ls, lb, w1_s, w2_s, u)
        ctx.cfg = (eps, plain, quant, w1.dtype, w2.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dp, ls, lb, w1, w2, u = ctx.saved_tensors
        eps, plain, quant, dt1, dt2 = ctx.cfg
        args = (x, dy.to(x.dtype).contiguous(), u, dp, ls, lb)
        if quant == "int8dx":
            bwd = mlp_train_bwd_q8dx_ref if plain else mlp_train_bwd_q8dx
            grads = bwd(*args, *quantize_weight_q8(w1, dim=0),
                        *quantize_weight_q8(w2, dim=0), eps)
        else:
            bwd = mlp_train_bwd_ref if plain else mlp_train_bwd
            grads = bwd(*args, w1, w2, eps)
        dx, dls, dlb, dw1, db1, dw2, db2 = grads
        return (dx, None, dls.to(ls.dtype), dlb.to(lb.dtype),
                dw1.to(w1.dtype).to(dt1), db1, dw2.to(w2.dtype).to(dt2), db2,
                None, None, None)


def fused_mlp_block(x, dp, ls, lb, w1, b1, w2, b2, eps: float = 1e-6,
                    plain: bool = False, quant=None):
    """y = x + dp * fc2(gelu(fc1(LN(x)))) with gradients to everything but
    dp. ``quant`` is None, ``"int8"`` or ``"int8dx"`` (module docstring).
    ``plain=True`` runs the plain versions on any device."""
    return _MlpTrain.apply(x, dp, ls, lb, w1, b1, w2, b2, eps, plain,
                           check_quant(quant))
