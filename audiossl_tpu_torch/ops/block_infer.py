"""Whole-block transformer kernels for inference forwards (K2, K3, and
their int8 variants K2q, K3q).

Port of ``audiossl_tpu/ops/pallas_block.py``: every no-grad encoder pass
(embedding extraction now, the EMA teacher later) runs each pre-LN block
as two residual halves,

* :func:`attn_block_infer` (``csrc/attn_block.cu``): LN1 -> qkv ->
  per-head exp-only softmax attention -> out-projection ->
  ``x + dp * y``;
* :func:`mlp_block_infer` (``csrc/mlp_block.cu``): LN2 -> fc1 -> exact
  GELU (A&S erf) -> fc2 -> ``x + dp * y``.

Attention masking follows the TPU kernel, not the additive -10000 mask
of the module path: invalid keys are zeroed in k (score 0, e = 1) and
excluded from the weighted sum and the denominator by a validity column
on v; a sequence with no valid key gets an all-ones value validity and
so attends uniformly over all keys. There is no max subtraction.

Rounding points (when x is bf16, as under ``load_model(fused=True)``):
LN output, qkv, ``e = exp(s)``, the attention output and the GELU output
are rounded to bf16 before the next product; products accumulate in f32;
LN and softmax statistics are f32. Weights are in torch's ``[out, in]``
layout and already in the compute dtype; LN parameters and biases f32.

``encoder_blocks_infer(quant="int8")`` (``load_model(fused=True,
quant="int8")``, the EMA teacher under ``teacher_quant="int8"``) runs the
four weight products of
each block as int8 x int8 -> int32 products: :func:`attn_block_infer_q8`
(K2q, ``pallas_block.py:179 _attn_kernel_q8``) and
:func:`mlp_block_infer_q8` (K3q, ``:223 _mlp_kernel_q8``). Their weights
are quantized per output channel from the weights as held (f32 masters),
once per call, as plain tensor operations (``ops/quant.py``); the
activations per row inside the kernels, from the f32 LN output, the
unrounded f32 attention output and the f32 GELU output. qkv and ``e`` stay
bf16 and the attention products are the float kernels'.

Each kernel wrapper takes its plain version (``*_ref``, same signature
and math) for a CPU tensor and launches its kernel for a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.models.transformer import erf_approx
from audiossl_tpu_torch.ops.quant import (check_codes, check_quant, q8_dot,
                                          quantize_weight_q8)

_INV_SQRT2 = 0.7071067811865476


def _ln(xf, w, b, eps):
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _dot(h, w, cdt):
    """f32 [.., K] x weight [J, K] -> f32 [.., J]: both operands rounded to
    the compute dtype, products accumulated in f32."""
    return h.to(cdt).float() @ w.to(cdt).float().t()


def _value_validity(validf):
    """A sequence with no valid key attends uniformly over all keys."""
    has = validf.sum(dim=1, keepdim=True) > 0.5
    return torch.where(has, validf, torch.ones_like(validf))


def _attn_core(x, valid, norm_w, norm_b, dot_qkv, dot_proj, num_heads: int,
               eps: float, dp: Optional[torch.Tensor], cdt):
    """The attention half shared by the float and int8 plain versions
    (``pallas_block.py:107 _attn_core``): ``dot_qkv`` and ``dot_proj`` map
    the f32 LN output and the unrounded f32 attention output to f32 rows,
    bias included; qkv and ``e = exp(s)`` are rounded to ``cdt``."""
    B, N, C = x.shape
    H = num_heads
    d = C // H
    dp = x.new_ones(B, dtype=torch.float32) if dp is None else dp.float()
    validf = valid.float()
    valid_v = _value_validity(validf)
    xf = x.float()
    h = _ln(xf, norm_w, norm_b, eps)
    qkv = dot_qkv(h).to(cdt).float()
    qkv = qkv.reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [B, H, N, d]
    kz = k * validf[:, None, :, None]
    vv = v * valid_v[:, None, :, None]
    s = torch.einsum("bhnd,bhmd->bhnm", q, kz) * d ** -0.5
    e = torch.exp(s).to(cdt).float()  # exp-only softmax numerator
    o = torch.einsum("bhnm,bhmd->bhnd", e, vv)
    den = torch.einsum("bhnm,bm->bhn", e, valid_v)
    o = o * (1.0 / (den + 1e-30))[..., None]
    o = o.permute(0, 2, 1, 3).reshape(B, N, C)
    y = dot_proj(o)
    return (xf + y * dp[:, None, None]).to(x.dtype)


def _biased(y, b):
    return y if b is None else y + b.float()


def attn_block_infer_ref(x, valid, norm_w, norm_b, w_qkv, b_qkv, w_proj,
                         b_proj, num_heads: int, eps: float = 1e-6,
                         dp: Optional[torch.Tensor] = None):
    """Plain version of :func:`attn_block_infer`."""
    cdt = x.dtype
    return _attn_core(
        x, valid, norm_w, norm_b,
        lambda h: _biased(_dot(h, w_qkv, cdt), b_qkv),
        lambda o: _dot(o, w_proj, cdt) + b_proj.float(),
        num_heads, eps, dp, cdt)


def attn_block_infer_q8_ref(x, valid, norm_w, norm_b, wq_qkv, s_qkv, b_qkv,
                            wq_proj, s_proj, b_proj, num_heads: int,
                            eps: float = 1e-6,
                            dp: Optional[torch.Tensor] = None):
    """Plain version of :func:`attn_block_infer_q8`
    (``pallas_block.py:179 _attn_kernel_q8``): int8 products of the f32 LN
    output and of the unrounded f32 attention output against per-channel
    weight codes; qkv and e in bf16."""
    return _attn_core(
        x, valid, norm_w, norm_b,
        lambda h: _biased(q8_dot(h, wq_qkv.t(), s_qkv), b_qkv),
        lambda o: q8_dot(o, wq_proj.t(), s_proj) + b_proj.float(),
        num_heads, eps, dp, torch.bfloat16)


def mlp_block_infer_ref(x, norm_w, norm_b, w1, b1, w2, b2,
                        eps: float = 1e-6,
                        dp: Optional[torch.Tensor] = None):
    """Plain version of :func:`mlp_block_infer`."""
    cdt = x.dtype
    dp = (x.new_ones(x.shape[0], dtype=torch.float32) if dp is None
          else dp.float())
    xf = x.float()
    h = _ln(xf, norm_w, norm_b, eps)
    a = _dot(h, w1, cdt) + b1.float()
    a = 0.5 * a * (1.0 + erf_approx(a * _INV_SQRT2))
    y = _dot(a, w2, cdt) + b2.float()
    return (xf + y * dp[:, None, None]).to(cdt)


def gelu_bound(u):
    """``max(gelu(rowmax(u)), 0.17)`` [.., 1]: a bound on |gelu(u)| per row
    from the signed row max of the pre-activation (gelu is monotone above
    its minimum of about -0.17), which K3q/K5q quantize the GELU output
    with (``pallas_block.py:231-237``)."""
    umax = u.amax(dim=-1, keepdim=True)
    gmax = 0.5 * umax * (1.0 + erf_approx(umax * _INV_SQRT2))
    return torch.clamp(gmax, min=0.17)


def mlp_block_infer_q8_ref(x, norm_w, norm_b, w1q, s1, b1, w2q, s2, b2,
                           eps: float = 1e-6,
                           dp: Optional[torch.Tensor] = None):
    """Plain version of :func:`mlp_block_infer_q8`
    (``pallas_block.py:223 _mlp_kernel_q8``): the f32 GELU output is
    quantized with the bound of :func:`gelu_bound`, not its absmax."""
    dp = (x.new_ones(x.shape[0], dtype=torch.float32) if dp is None
          else dp.float())
    xf = x.float()
    h = _ln(xf, norm_w, norm_b, eps)
    u = q8_dot(h, w1q.t(), s1) + b1.float()
    a = 0.5 * u * (1.0 + erf_approx(u * _INV_SQRT2))
    y = q8_dot(a, w2q.t(), s2, bound=gelu_bound(u)) + b2.float()
    return (xf + y * dp[:, None, None]).to(x.dtype)


def _check_block(name, x, weights, f32s):
    if x.dtype != torch.bfloat16 or any(
            w.dtype != torch.bfloat16 for w in weights):
        raise ValueError(f"{name}: the kernel takes bf16 activations and "
                         "weights (load_model(fused=True) casts them)")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError(f"{name}: LN parameters and biases must be f32")
    C = x.shape[-1]
    if any(w.shape[1] % 32 for w in weights) or C % 32:
        raise ValueError(f"{name}: widths must be multiples of 32, got "
                         f"{[tuple(w.shape) for w in weights]}")
    kb.require_cuda(name, x, *weights, *f32s)


def attn_block_infer(x, valid, norm_w, norm_b, w_qkv, b_qkv, w_proj,
                     b_proj, num_heads: int, eps: float = 1e-6,
                     dp: Optional[torch.Tensor] = None):
    """Attention residual half of a pre-LN block.

    x [B, N, C]; valid [B, N] 0/1 key mask; w_qkv [3C, C]; b_qkv [3C] or
    None (qkv_bias=False archs: zeros); w_proj [C, C]; b_proj [C]; dp
    optional per-sample drop-path keep multiplier [B] (0 or 1/keep)."""
    if x.device.type == "cpu":
        return attn_block_infer_ref(x, valid, norm_w, norm_b, w_qkv, b_qkv,
                                    w_proj, b_proj, num_heads, eps, dp)
    B, N, C = x.shape
    d = C // num_heads
    if B > 65535:  # one grid.z slice per sequence in the attention kernel
        raise ValueError(f"attn_block_infer: {B} sequences, at most 65535")
    if d not in (32, 64, 128) or d * num_heads != C:
        raise ValueError(f"attn_block_infer: head dim {C}/{num_heads} "
                         "must be 32, 64 or 128")
    if b_qkv is None:
        b_qkv = torch.zeros(3 * C, device=x.device, dtype=torch.float32)
    dp = (torch.ones(B, device=x.device, dtype=torch.float32) if dp is None
          else dp.float().contiguous())
    validf = valid.float().contiguous()
    valid_v = _value_validity(validf)
    if tuple(w_qkv.shape) != (3 * C, C) or tuple(w_proj.shape) != (C, C):
        raise ValueError("attn_block_infer: weight shapes do not match C")
    _check_block("attn_block_infer", x, (w_qkv, w_proj),
                 (validf, dp, norm_w, norm_b, b_qkv, b_proj))
    M = B * N
    h = torch.empty(M, C, device=x.device, dtype=torch.bfloat16)
    qkv = torch.empty(M, 3 * C, device=x.device, dtype=torch.bfloat16)
    o = torch.empty(M, C, device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    kb.launch("attn_block", x.device, *map(kb.ptr, (
        x, validf, valid_v, dp, norm_w, norm_b, w_qkv, b_qkv, w_proj, b_proj,
        out, h, qkv, o)), B, N, C, num_heads, d ** -0.5, eps)
    return out


def mlp_block_infer(x, norm_w, norm_b, w1, b1, w2, b2, eps: float = 1e-6,
                    dp: Optional[torch.Tensor] = None):
    """MLP residual half of a pre-LN block: x [B, N, C]; w1 [Hd, C];
    b1 [Hd]; w2 [C, Hd]; b2 [C]; dp as in :func:`attn_block_infer`."""
    if x.device.type == "cpu":
        return mlp_block_infer_ref(x, norm_w, norm_b, w1, b1, w2, b2, eps, dp)
    B, N, C = x.shape
    Hd = w1.shape[0]
    if tuple(w1.shape) != (Hd, C) or tuple(w2.shape) != (C, Hd):
        raise ValueError("mlp_block_infer: weight shapes do not match C")
    dp = (torch.ones(B, device=x.device, dtype=torch.float32) if dp is None
          else dp.float().contiguous())
    _check_block("mlp_block_infer", x, (w1, w2), (dp, norm_w, norm_b, b1, b2))
    M = B * N
    h = torch.empty(M, C, device=x.device, dtype=torch.bfloat16)
    u = torch.empty(M, Hd, device=x.device, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    kb.launch("mlp_block", x.device, *map(kb.ptr, (
        x, dp, norm_w, norm_b, w1, b1, w2, b2, out, h, u)), B, N, C, Hd, eps)
    return out


def _check_q8(name, x, codes, f32s):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 activations")
    check_codes(name, *codes)
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError(f"{name}: scales, LN parameters and biases must be "
                         "f32")
    kb.require_cuda(name, x, *codes, *f32s)


def attn_block_infer_q8(x, valid, norm_w, norm_b, wq_qkv, s_qkv, b_qkv,
                        wq_proj, s_proj, b_proj, num_heads: int,
                        eps: float = 1e-6, dp: Optional[torch.Tensor] = None):
    """K2q: :func:`attn_block_infer` with int8 qkv and proj products.
    wq_qkv [3C, C] / wq_proj [C, C] int8 codes with per-output-channel
    scales s_qkv [3C] / s_proj [C] (``ops.quant.quantize_weight_q8``);
    x bf16 on the card."""
    if x.device.type == "cpu":
        return attn_block_infer_q8_ref(x, valid, norm_w, norm_b, wq_qkv,
                                       s_qkv, b_qkv, wq_proj, s_proj, b_proj,
                                       num_heads, eps, dp)
    B, N, C = x.shape
    d = C // num_heads
    if B > 65535:
        raise ValueError(f"attn_block_infer_q8: {B} sequences, at most 65535")
    if d not in (32, 64, 128) or d * num_heads != C:
        raise ValueError(f"attn_block_infer_q8: head dim {C}/{num_heads} "
                         "must be 32, 64 or 128")
    if tuple(wq_qkv.shape) != (3 * C, C) or tuple(wq_proj.shape) != (C, C):
        raise ValueError("attn_block_infer_q8: weight shapes do not match C")
    if b_qkv is None:
        b_qkv = torch.zeros(3 * C, device=x.device, dtype=torch.float32)
    dp = (torch.ones(B, device=x.device, dtype=torch.float32) if dp is None
          else dp.float().contiguous())
    validf = valid.float().contiguous()
    valid_v = _value_validity(validf)
    _check_q8("attn_block_infer_q8", x, (wq_qkv, wq_proj),
              (validf, dp, norm_w, norm_b, s_qkv, b_qkv, s_proj, b_proj))
    M = B * N
    dev = x.device
    hq = torch.empty(M, C, device=dev, dtype=torch.int8)
    oq = torch.empty(M, C, device=dev, dtype=torch.int8)
    hr = torch.empty(M, device=dev, dtype=torch.float32)
    orr = torch.empty(M, device=dev, dtype=torch.float32)
    qkv = torch.empty(M, 3 * C, device=dev, dtype=torch.bfloat16)
    o = torch.empty(M, C, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    kb.launch("attn_block_q8", dev, *map(kb.ptr, (
        x, validf, valid_v, dp, norm_w, norm_b, wq_qkv, s_qkv, b_qkv, wq_proj,
        s_proj, b_proj, out, hq, hr, qkv, o, oq, orr)),
        B, N, C, num_heads, d ** -0.5, eps)
    return out


def mlp_block_infer_q8(x, norm_w, norm_b, w1q, s1, b1, w2q, s2, b2,
                       eps: float = 1e-6, dp: Optional[torch.Tensor] = None):
    """K3q: :func:`mlp_block_infer` with int8 fc1 and fc2 products. w1q
    [Hd, C] / w2q [C, Hd] int8 codes with per-output-channel scales s1 [Hd]
    / s2 [C]; x bf16 on the card."""
    if x.device.type == "cpu":
        return mlp_block_infer_q8_ref(x, norm_w, norm_b, w1q, s1, b1, w2q, s2,
                                      b2, eps, dp)
    B, N, C = x.shape
    Hd = w1q.shape[0]
    if tuple(w1q.shape) != (Hd, C) or tuple(w2q.shape) != (C, Hd):
        raise ValueError("mlp_block_infer_q8: weight shapes do not match C")
    dp = (torch.ones(B, device=x.device, dtype=torch.float32) if dp is None
          else dp.float().contiguous())
    _check_q8("mlp_block_infer_q8", x, (w1q, w2q),
              (dp, norm_w, norm_b, s1, b1, s2, b2))
    M = B * N
    dev = x.device
    hq = torch.empty(M, C, device=dev, dtype=torch.int8)
    aq = torch.empty(M, Hd, device=dev, dtype=torch.int8)
    hr = torch.empty(M, device=dev, dtype=torch.float32)
    ar = torch.empty(M, device=dev, dtype=torch.float32)
    u = torch.empty(M, Hd, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    kb.launch("mlp_block_q8", dev, *map(kb.ptr, (
        x, dp, norm_w, norm_b, w1q, s1, b1, w2q, s2, b2, out, hq, hr, u, aq,
        ar)), B, N, C, Hd, eps)
    return out


def encoder_blocks_infer(blocks: Sequence[torch.nn.Module], x, lengths,
                         num_heads: int, eps: float = 1e-6,
                         collect_from: Optional[int] = None,
                         dps: Optional[torch.Tensor] = None,
                         dtype: Optional[torch.dtype] = None,
                         plain: bool = False, quant: Optional[str] = None):
    """Run the pre-LN ``Block`` stack with the block kernels.

    x [B, N, C] tokens; lengths [B] valid token counts or None. ``dtype``
    is the compute dtype (default: the blocks' weight dtype); weights held
    in another dtype (the EMA teacher's f32 masters) are cast to it on
    every call, as the Pallas wrappers cast them. ``dps`` [depth, 2, B]
    are per-sample stochastic-depth keep multipliers of the attention and
    MLP halves (a train-mode teacher, see
    ``models.transformer.drop_path_multipliers``). ``quant="int8"`` runs
    K2q/K3q, with each block's weights quantized from the weights as held
    on every call (``pallas_block.py:418 encoder_blocks_infer``).
    ``plain=True`` runs the kernels' plain versions on any device (each
    multiplier row is copied, so every kernel input starts 16-byte
    aligned). Unlike the TPU kernels the token count is not padded to a
    multiple of 128, so a sequence with no valid token attends uniformly
    over its N keys. Returns (x, outputs of the blocks
    ``i >= collect_from``)."""
    quant = check_quant(quant, ("int8",))
    B, N, _ = x.shape
    dtype = dtype or blocks[0].attn.qkv.weight.dtype
    x = x.to(dtype).contiguous()
    if lengths is None:
        valid = torch.ones(B, N, device=x.device)
    else:
        valid = (torch.arange(N, device=x.device)[None, :]
                 < lengths[:, None]).float()
    if quant:
        attn = attn_block_infer_q8_ref if plain else attn_block_infer_q8
        mlp = mlp_block_infer_q8_ref if plain else mlp_block_infer_q8

        def w(lin):  # int8 codes and their per-output-channel scales
            return quantize_weight_q8(lin.weight)
    else:
        attn = attn_block_infer_ref if plain else attn_block_infer
        mlp = mlp_block_infer_ref if plain else mlp_block_infer

        def w(lin):
            return (lin.weight.to(dtype),)

    collected = []
    for i, blk in enumerate(blocks):
        x = attn(x, valid, blk.norm1.weight, blk.norm1.bias,
                 *w(blk.attn.qkv), blk.attn.qkv.bias, *w(blk.attn.proj),
                 blk.attn.proj.bias, num_heads, eps,
                 dp=None if dps is None else dps[i, 0].clone())
        x = mlp(x, blk.norm2.weight, blk.norm2.bias, *w(blk.mlp.fc1),
                blk.mlp.fc1.bias, *w(blk.mlp.fc2), blk.mlp.fc2.bias, eps,
                dp=None if dps is None else dps[i, 1].clone())
        if collect_from is not None and i >= collect_from:
            collected.append(x)
    return x, collected
