"""BatchNorm with torch semantics over masked rows (PyTorch port).

Port of ``audiossl_tpu/models/norm.py:24 BatchNorm1d``, written out by
hand because ``torch.nn.BatchNorm1d`` takes no row mask: the frame-level
heads normalize only the selected (masked and valid) frames. Semantics as
torch's: eps 1e-5, running statistics updated with momentum 0.1 from the
*unbiased* variance (with the masked row count n), normalization by the
*biased* batch variance in training; statistics and normalization in f32
over an input of any dtype, the output in the input's dtype.
``affine=False`` (the linear probe's head) holds no scale and bias.

Under a process group of more than one rank the training statistics are
those of the global batch, as under the JAX package's data mesh: the
count and sum, then the centred sum of squares, each summed over ranks
by ``parallel.all_reduce_sum`` (whose backward is the global one), so
every rank normalizes alike and updates the same running statistics.
Under ``parallel.replicated`` (a batch every rank runs whole) they are
the rank's own, as one process takes them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audiossl_tpu_torch.parallel.mesh import all_reduce_sum, data_world


class BatchNorm1d(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5, device=None, affine: bool = True):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(features, device=device))
            self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [..., features]; mask (optional) [...], True on the rows that
        count. Training mode uses and updates the batch statistics; eval
        mode normalizes by the running ones."""
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            if data_world().size > 1:
                n, mean, var = _global_stats(xf, mask, axes)
            elif mask is None:
                n = torch.tensor(float(xf[..., 0].numel()), device=x.device)
                mean = xf.mean(dim=axes)
                var = ((xf - mean) ** 2).mean(dim=axes)
            else:
                w = mask.float()[..., None]
                n = w.sum()
                mean = (xf * w).sum(dim=axes) / n
                var = (((xf - mean) ** 2) * w).sum(dim=axes) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var
                                       + self.momentum * unbiased)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        if self.affine:
            y = y * self.weight + self.bias
        return y.to(x.dtype)


def _global_stats(xf, mask, axes):
    """(count, mean, biased variance) over the rows of every rank, in two
    passes as one process takes them."""
    if mask is None:
        w = None
        cnt = xf.new_tensor([float(xf[..., 0].numel())])
        s = xf.sum(dim=axes)
    else:
        w = mask.float()[..., None]
        cnt = w.sum().reshape(1)
        s = (xf * w).sum(dim=axes)
    tot = all_reduce_sum(torch.cat([s, cnt]))
    n = tot[-1]
    mean = tot[:-1] / n
    d2 = (xf - mean) ** 2
    if w is not None:
        d2 = d2 * w
    return n, mean, all_reduce_sum(d2.sum(dim=axes)) / n
