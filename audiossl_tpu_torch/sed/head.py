"""SED head: per-frame sigmoid "strong" scores and their attention-pooled
"weak" clip scores (PyTorch port of ``audiossl_tpu/sed/head.py``;
reference ``downstream/utils_dcase/model_dcase.py:38-69`` LinearHead).

Two parallel linear layers on the frame embeddings: strong =
sigmoid(linear(x) / temp) per frame, weak = the softmax-attention pooling
sum(strong * soft) / sum(soft) over time. The parameter names are JAX's
module names (``linear``, ``linear_softmax``).

With ``use_norm`` the embeddings are normalized by their mean and
population variance over (B, T). Under a process group they are the
global batch's, as under JAX's data mesh: the sum and count, then the
centred sum of squares, each summed over ranks by
``parallel.all_reduce_sum`` (whose backward is the global one).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audiossl_tpu_torch.parallel.mesh import all_reduce_sum, data_world


class SEDHead(nn.Module):
    def __init__(self, embed_dim: int, num_labels: int,
                 use_norm: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        """Weights normal(0, 0.01) and zero biases, drawn on the CPU from
        ``generator`` (seed 0 when None), then moved to ``device``."""
        super().__init__()
        self.use_norm = use_norm
        # built on the meta device, so nothing draws from the global RNG
        self.linear = nn.Linear(embed_dim, num_labels, device="meta")
        self.linear_softmax = nn.Linear(embed_dim, num_labels, device="meta")
        self.to_empty(device="cpu")
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        with torch.no_grad():
            for lin in (self.linear, self.linear_softmax):
                nn.init.normal_(lin.weight, std=0.01, generator=gen)
                lin.bias.zero_()
        self.to(device)

    def forward(self, x: torch.Tensor, temp: float = 1.0,
                frame_mask: Optional[torch.Tensor] = None):
        """x: [B, T, D] frame embeddings -> (strong [B, C, T], weak
        [B, C]). ``frame_mask`` [B, T] optionally excludes padded frames
        from the weak pooling."""
        if self.use_norm:  # over (B, T), the population variance
            if data_world().size > 1:
                mu, var = _global_moments(x)
            else:
                mu = x.mean(dim=(0, 1), keepdim=True)
                var = x.var(dim=(0, 1), unbiased=False, keepdim=True)
            x = (x - mu) / torch.sqrt(var + 1e-5)
        strong = torch.sigmoid(self.linear(x) / temp)  # [B, T, C]
        soft = torch.softmax(self.linear_softmax(x), dim=-1).clamp(1e-7, 1.0)
        if frame_mask is not None:
            soft = soft * frame_mask[:, :, None].to(x.dtype)
        weak = (strong * soft).sum(dim=1) / soft.sum(dim=1).clamp_min(1e-7)
        return strong.transpose(1, 2), weak


def _global_moments(x: torch.Tensor):
    """The mean and population variance [1, 1, D] of ``x`` [B, T, D] over
    every rank's (B, T), in two passes as one process takes them."""
    tot = all_reduce_sum(torch.cat([x.sum(dim=(0, 1)),
                                    x.new_tensor([float(x[..., 0].numel())])]))
    n = tot[-1]
    mu = (tot[:-1] / n)[None, None]
    var = all_reduce_sum(((x - mu) ** 2).sum(dim=(0, 1))) / n
    return mu, var[None, None]
