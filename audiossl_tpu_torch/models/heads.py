"""Downstream classification heads (PyTorch port of
``audiossl_tpu/models/heads.py``; reference ``audiossl/modules/head.py``).

:class:`LinearHead` is the linear probe's and the finetuning head:
BatchNorm1d without scale and bias, then a Linear with a normal(0, 0.01)
weight and a zero bias. :class:`AttentionHead` is the reference's
attention head: a pre-Linear, a CLS token before the frames, one
transformer ``Block``, the CLS row through BatchNorm1d without scale and
bias, then a Linear. Parameter names are the reference's
(``norm.running_mean``, ``linear.weight``, ``att.attn.qkv.weight``, ...).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audiossl_tpu_torch.models.byol import lecun_normal_
from audiossl_tpu_torch.models.norm import BatchNorm1d
from audiossl_tpu_torch.models.transformer import Block


class LinearHead(nn.Module):
    def __init__(self, in_dim: int, num_labels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        """The weight is drawn on the CPU from ``generator`` (seed 0 when
        None), then moved to ``device``."""
        super().__init__()
        self.norm = BatchNorm1d(in_dim, affine=False)
        # built on the meta device, so nothing draws from the global RNG
        self.linear = nn.Linear(in_dim, num_labels, device="meta")
        self.linear.to_empty(device="cpu")
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        with torch.no_grad():
            nn.init.normal_(self.linear.weight, std=0.01, generator=gen)
            self.linear.bias.zero_()
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, in_dim] -> logits [B, num_labels]; the norm uses batch
        statistics in training mode and its running ones in eval mode."""
        return self.linear(self.norm(x))


class AttentionHead(nn.Module):
    """JAX's ``AttentionHead`` (``audiossl_tpu/models/heads.py:30``;
    reference ``modules/head.py:72-89``): x [B, T, in_dim] -> Linear to
    ``att_dim`` -> the CLS token prepended -> one pre-LN ``Block`` (no
    mask, no drop path) -> its CLS row -> BatchNorm1d(affine=False) ->
    Linear to ``num_labels``. Parameters are drawn on the CPU from
    ``generator`` (seed 0 when None) as flax initializes them (LeCun
    normal Linear weights, zero biases, a truncated normal(0.02) CLS
    token), then moved to ``device``."""

    def __init__(self, in_dim: int, att_dim: int, num_heads: int,
                 num_labels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        meta = "meta"  # nothing draws from the global RNG
        self.pre_linear = nn.Linear(in_dim, att_dim, device=meta)
        self.cls_token = nn.Parameter(torch.empty(1, 1, att_dim,
                                                  device=meta))
        self.att = Block(att_dim, num_heads, device=meta)
        self.norm = BatchNorm1d(att_dim, affine=False, device=meta)
        self.linear = nn.Linear(att_dim, num_labels, device=meta)
        self.to_empty(device="cpu")
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        with torch.no_grad():
            nn.init.trunc_normal_(self.cls_token, std=0.02, a=-0.04, b=0.04,
                                  generator=gen)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight, gen)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            self.norm.running_mean.zero_()
            self.norm.running_var.fill_(1.0)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, in_dim] -> logits [B, num_labels]; the norm uses batch
        statistics in training mode and its running ones in eval mode."""
        x = self.pre_linear(x)
        cls = self.cls_token.expand(x.shape[0], 1, x.shape[-1])
        x = self.att(torch.cat([cls, x], dim=1))[:, 0]
        return self.linear(self.norm(x))
