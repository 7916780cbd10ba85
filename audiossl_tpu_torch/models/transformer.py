"""Pre-norm ViT blocks with variable-length attention masking (PyTorch).

Port of ``audiossl_tpu/models/transformer.py`` (reference
``audiossl/modules/transformer.py``): ``Attention`` (joint qkv
projection, additive -10000 padding mask), ``Mlp`` (exact GELU through
the A&S erf polynomial; on the card a kernel forward and backward) and
the pre-norm residual ``Block``, whose residual branches take per-sample
stochastic-depth multipliers in training (:func:`drop_path`). Parameter
names are the reference's torch names, so reference state dicts load as
they are. The modules compute in the dtype of their input: f32 master
weights are cast to it per call, and LayerNorm statistics are f32.

``fused_attention=True`` (an encoder that runs neither block kernel, such
as an f32 pretraining encoder) sends ``Attention``'s packed qkv through the
standalone MHA kernel K6 (``ops/mha.py``) and makes ``Block``'s norms
:class:`LayerNormPG` (kernel K8 for their backward), as the JAX modules do;
without it the module path is unchanged. ``plain=True`` runs those
kernels' plain versions on any device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# The reference uses an additive -10000 mask (not -inf); kept for parity.
MASK_VALUE = -10000.0


def length_to_attn_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] token counts -> additive attention mask [B, 1, 1, max_len]."""
    pos = torch.arange(max_len, device=lengths.device)
    pad = pos[None, :] >= lengths[:, None]  # True where padded
    return (pad.float() * MASK_VALUE)[:, None, None, :]


def length_to_token_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] token counts -> boolean validity mask [B, max_len]."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def _erf_poly(x: torch.Tensor) -> torch.Tensor:
    s = torch.sign(x)
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-a * a))


class _ErfApprox(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _erf_poly(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * (1.1283791670955126 * torch.exp(-x * x))


def erf_approx(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7), the form the
    JAX package and its kernels use in place of a true erf. Its gradient
    is the exact derivative 2/sqrt(pi) exp(-x^2), as the JAX function's
    custom JVP gives it (not the derivative of the polynomial), and
    autograd keeps only x for it."""
    return _ErfApprox.apply(x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Erf-form GELU (torch.nn.GELU's default), computed in f32 with
    :func:`erf_approx`, in x's dtype. On the CPU the eager chain
    (``ops/gelu.py:gelu_fwd_ref``, autograd through it); on the card one
    kernel forward and one backward, which keep only x for the gradient."""
    from audiossl_tpu_torch.ops import gelu  # imports this module

    return gelu.gelu_fwd_ref(x) if x.device.type == "cpu" else gelu.gelu(x)


def drop_path_multipliers(u: torch.Tensor, rate: float) -> torch.Tensor:
    """Per-sample stochastic-depth keep multipliers from uniforms
    u [depth, ...]: ``floor(keep + u) / keep`` (0 or 1/keep) with the rate
    ramped linearly over depth, ``rate * i / (depth - 1)`` for block i
    (reference modules/transformer.py:56-66; the JAX package's
    ``pallas_block.encoder_blocks_infer`` draws u of shape [depth, 2, B])."""
    depth = u.shape[0]
    rates = torch.tensor([rate * i / max(depth - 1, 1) for i in range(depth)],
                         dtype=torch.float32, device=u.device)
    keep = (1.0 - rates).reshape((depth,) + (1,) * (u.ndim - 1))
    return torch.floor(keep + u) / keep


def drop_path(x: torch.Tensor, dp: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample stochastic depth: x [B, ...] times its sample's keep
    multiplier dp [B] (None: no drop)."""
    if dp is None:
        return x
    return x * dp.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The Linear in x's dtype (weights cast per call)."""
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), b)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics, output in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


class LayerNormPG(nn.LayerNorm):
    """``nn.LayerNorm`` (the same parameter names) computed as the JAX
    package's ``LayerNormPG``: the fast-variance forward in f32, output in
    x's dtype, and the single-pass backward K8 (``ops/layer_norm.py``).
    Its forward uses ``max(mean(x^2) - mu^2, 0)`` for the variance, where
    ``nn.LayerNorm`` takes the two-pass one."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 plain: bool = False):
        super().__init__(dim, eps=eps, device=device)
        self.plain = plain

    def forward(self, x):
        from audiossl_tpu_torch.ops.layer_norm import layer_norm

        return layer_norm(x, self.weight, self.bias, self.eps, x.dtype,
                          self.plain)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 device=None, fused_attention: bool = False,
                 plain: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.fused_attention = fused_attention
        self.plain = plain
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x, attn_mask=None, return_attention: bool = False):
        """``return_attention``: the softmax map [B, H, N, N] of the module
        path with the additive mask, never a kernel's (JAX's
        ``Attention(return_attention=True)``)."""
        B, N, C = x.shape
        H = self.num_heads
        d = C // H
        if self.fused_attention and not return_attention:
            # imported here: ops.mha imports the kernel build
            from audiossl_tpu_torch.ops.mha import fused_mha

            m2 = (x.new_zeros(B, N, dtype=torch.float32) if attn_mask is None
                  else attn_mask[:, 0, 0, :].float())
            out = fused_mha(_linear(self.qkv, x), m2, H, d ** -0.5,
                            self.plain)
            return _linear(self.proj, out.to(x.dtype))
        qkv = _linear(self.qkv, x).reshape(B, N, 3, H, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * d ** -0.5
        if attn_mask is not None:
            attn = attn + attn_mask.to(attn.dtype)
        attn = attn.softmax(dim=-1)
        if return_attention:
            return attn
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        return _linear(self.proj, out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, device=device)

    def forward(self, x):
        return _linear(self.fc2, gelu_exact(_linear(self.fc1, x)))


def _norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A block's or encoder's norm in x's dtype: :class:`LayerNormPG` as it
    is, ``nn.LayerNorm`` through :func:`_layer_norm`."""
    return ln(x) if isinstance(ln, LayerNormPG) else _layer_norm(ln, x)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, eps: float = 1e-6, device=None,
                 fused_attention: bool = False, plain: bool = False):
        super().__init__()

        def norm():
            if fused_attention:
                return LayerNormPG(dim, eps, device, plain)
            return nn.LayerNorm(dim, eps=eps, device=device)

        self.norm1 = norm()
        self.attn = Attention(dim, num_heads, qkv_bias, device,
                              fused_attention, plain)
        self.norm2 = norm()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x, attn_mask=None,
                dp: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_attention: bool = False):
        """dp: the keep multipliers [B] of the attention and the MLP
        residual branch (training), or None. ``return_attention``: the
        attention's softmax map [B, H, N, N] of ``norm1(x)`` instead of the
        block's output (reference ``Block.forward(return_attention=True)``)."""
        if return_attention:
            return self.attn(_norm(self.norm1, x), attn_mask,
                             return_attention=True)
        dp1, dp2 = (None, None) if dp is None else dp
        x = x + drop_path(self.attn(_norm(self.norm1, x), attn_mask), dp1)
        return x + drop_path(self.mlp(_norm(self.norm2, x)), dp2)
