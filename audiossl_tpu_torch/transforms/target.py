"""Label-aware mixup (PyTorch port of ``audiossl_tpu/transforms/target.py``;
reference ``transforms/target_transform.py``).

Each item is mixed with a partner from the same batch rolled by one shift
for the whole batch, ``torch.roll``'s direction (row i with row
``(i - shift) % B``), and its labels with the same weights. The weights
``lam`` [B] (Beta(alpha, alpha) in the reference) and the shift are handed
in: ``torch.distributions.Beta`` takes no generator, so a caller draws
them from one it holds (:func:`draw_mixup_label`).

Under a process group ``spec`` and ``label`` are a rank's rows of the
global batch, and the roll is the global batch's (JAX's under its data
mesh): the partners come from every rank (``parallel.all_gather_rows``).
"""
from __future__ import annotations

import numpy as np
import torch

from audiossl_tpu_torch.parallel.mesh import (all_gather_rows, data_world,
                                              local_rows)

_EPS = 1e-7


def draw_mixup_label(rng: np.random.Generator, gen: torch.Generator,
                     batch: int, alpha: float):
    """(lam [B] ~ Beta(alpha, alpha) from ``rng`` on the host, as f32; a
    shift in [1, B - 1] from ``gen``)."""
    lam = torch.from_numpy(rng.beta(alpha, alpha, batch).astype(np.float32))
    shift = int(torch.randint(1, max(batch, 2), (), generator=gen))
    return lam, shift


def mixup_spec_label(spec: torch.Tensor, label: torch.Tensor,
                     lam: torch.Tensor, shift: int):
    """spec [B, F, T] in the log domain, label [B, C] (one- or many-hot, or
    already soft) -> (log(lam exp(spec) + (1 - lam) exp(partner) + 1e-7),
    lam label + (1 - lam) partner's label)."""
    spec2, label2 = (_partners(t, shift) for t in (spec, label))
    l3 = lam[:, None, None]
    mixed = torch.log(l3 * torch.exp(spec) + (1 - l3) * torch.exp(spec2)
                      + _EPS)
    y = lam[:, None] * label + (1 - lam[:, None]) * label2
    return mixed, y



def _partners(x: torch.Tensor, shift: int) -> torch.Tensor:
    """The rows of the global batch rolled by ``shift`` that face this
    rank's rows of ``x``."""
    if data_world().size == 1:
        return torch.roll(x, shift, dims=0)
    whole = all_gather_rows(x)
    return torch.roll(whole, shift, dims=0)[local_rows(whole.shape[0])]
