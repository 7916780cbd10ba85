"""Downstream classification heads (PyTorch port of
``audiossl_tpu/models/heads.py``; reference ``audiossl/modules/head.py``).

:class:`LinearHead` is the linear probe's and the finetuning head:
BatchNorm1d without scale and bias, then a Linear with a normal(0, 0.01)
weight and a zero bias. Parameter names are the reference's (``norm.running_mean``,
``linear.weight``, ...).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audiossl_tpu_torch.models.norm import BatchNorm1d


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
