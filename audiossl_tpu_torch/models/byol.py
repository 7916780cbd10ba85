"""BYOL projector/predictor heads and the clip- and frame-level
teacher-student losses (PyTorch port of ``audiossl_tpu/models/byol.py``).

Head matmuls run in the encoder's compute dtype (bf16 at the training
step); the masked BatchNorm computes in f32 and returns that dtype; the
head output, the normalization and the loss are f32. Frame-level losses
take the whole frame sequence and a boolean selection mask instead of a
dynamic gather (the same masked math).

Under a process group of more than one rank every reduction over the
batch is global, as under the JAX package's data mesh: the BatchNorm
statistics (``models/norm.py``), the feature std (its sums over ranks)
and the losses' means, whose denominators count the rows of every rank.
Each rank's loss is then its share: the ranks' shares sum to the loss of
the global batch, so the gradients summed over ranks are its gradients.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiossl_tpu_torch.models.norm import BatchNorm1d
from audiossl_tpu_torch.parallel.mesh import all_reduce_sum, world


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense init: truncated normal (2 std) of variance
    1 / fan_in after truncation."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class MLPHead(nn.Module):
    """Linear (no bias) -> masked BatchNorm -> ReLU -> Linear (no bias)
    (reference build_mlp(2, in, hidden, out, last_bn=False))."""

    def __init__(self, in_dim: int, hidden_dim: int = 4096,
                 out_dim: int = 256, device=None):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, hidden_dim, bias=False, device=device)
        self.bn0 = BatchNorm1d(hidden_dim, device=device)
        self.fc1 = nn.Linear(hidden_dim, out_dim, bias=False, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.fc0.weight, generator)
        lecun_normal_(self.fc1.weight, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = F.linear(x.to(dtype), self.fc0.weight.to(dtype))
        x = torch.relu(self.bn0(x, mask))
        return F.linear(x, self.fc1.weight.to(dtype)).float()


class Projector(nn.Module):
    """The projector (``"mlp"``: an :class:`MLPHead`; ``"linear"``: a
    Linear of the embedding width with bias, the data2vec student's,
    named ``projector_linear``; ``"none"``) and, for the student, the MLP
    predictor. The linear projector computes and returns ``dtype`` as
    flax's ``Dense`` does (its product, then its bias, each rounded)."""

    def __init__(self, embed_dim: int, predictor: bool = True,
                 hidden_dim: int = 4096, out_dim: int = 256, device=None,
                 projector: str = "mlp"):
        super().__init__()
        if projector not in ("mlp", "linear", "none"):
            raise ValueError(f"unknown projector {projector!r}")
        self.projector = (MLPHead(embed_dim, hidden_dim, out_dim, device)
                          if projector == "mlp" else None)
        self.projector_linear = (nn.Linear(embed_dim, embed_dim,
                                           device=device)
                                 if projector == "linear" else None)
        self.predictor = (MLPHead(out_dim, hidden_dim, out_dim, device)
                          if predictor else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's Dense init: lecun normal weights, zero bias."""
        for head in (self.projector, self.predictor):
            if head is not None:
                head.reset_parameters(generator)
        if self.projector_linear is not None:
            lecun_normal_(self.projector_linear.weight, generator)
            self.projector_linear.bias.zero_()

    def forward(self, x, mask=None, dtype=torch.float32):
        if self.projector is not None:
            x = self.projector(x, mask, dtype)
        elif self.projector_linear is not None:
            lin = self.projector_linear
            x = x.to(dtype) @ lin.weight.to(dtype).t() + lin.bias.to(dtype)
        if self.predictor is not None:
            x = self.predictor(x, mask, dtype)
        return x


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis (torch F.normalize)."""
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def feature_std(y: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """Mean per-dimension std of y's (selected) rows (reference
    compute_var)."""
    d = y.shape[-1]
    y2 = y.reshape(-1, d)
    if mask is not None:
        w = mask.reshape(-1, 1).to(y2.dtype)
        zc = w.sum()
        zs = (y2 * w).sum(dim=0)
        zss = ((y2 ** 2) * w).sum(dim=0)
    else:
        zc = torch.tensor(float(y2.shape[0]), device=y.device)
        zs = y2.sum(dim=0)
        zss = (y2 ** 2).sum(dim=0)
    if world().size > 1:  # the sums of every rank's rows, summed in f32
        tot = all_reduce_sum(torch.cat([zc.reshape(1), zs, zss]).float())
        tot = tot.to(y2.dtype)
        zc, zs, zss = tot[0], tot[1:d + 1], tot[d + 1:]
    var = zss / (zc - 1) - zs ** 2 / (zc * (zc - 1))
    return torch.sqrt(var + 1e-6).mean()


def byol_pair_loss(p, z, mask: Optional[torch.Tensor] = None):
    """2 - 2 cos(p, z), averaged over the (selected) rows; under a group of
    n ranks this rank's share, 2 / n - 2 (its sum of cos) / (the global
    count)."""
    cos = (l2_normalize(p) * l2_normalize(z)).sum(dim=-1)
    n = world().size
    if n > 1:
        if mask is None:
            total = cos.sum()
            count = torch.tensor(float(cos.numel()), device=cos.device)
        else:
            total = (cos * mask.to(cos.dtype)).sum()
            count = mask.float().sum()
        # the count in f32, rounded once to cos's dtype as one process's
        count = all_reduce_sum(count.float()).to(cos.dtype)
        if mask is not None:
            count = torch.clamp(count, min=1.0)
        return 2.0 / n - 2.0 * total / count
    if mask is not None:
        w = mask.to(cos.dtype)
        return 2.0 - 2.0 * (cos * w).sum() / torch.clamp(w.sum(), min=1.0)
    return 2.0 - 2.0 * cos.mean()


class ByolLossState(NamedTuple):
    loss: torch.Tensor
    std_student: torch.Tensor
    std_teacher: torch.Tensor


def clip_byol_loss(student, teacher, ncrops: int = 2) -> ByolLossState:
    """Clip-level cross-view loss (reference models/atst/byol.py:57-78):
    student [ncrops * B, D] predictor outputs and teacher [2B, D] projector
    outputs, both stacked view-major; the pairs with iq == iv are
    skipped."""
    std_s = feature_std(l2_normalize(student))
    std_t = feature_std(l2_normalize(teacher))
    s_views = student.chunk(ncrops, dim=0)
    t_views = teacher.chunk(2, dim=0)
    total, n_terms = 0.0, 0
    for iq, q in enumerate(t_views):
        for iv, v in enumerate(s_views):
            if iq == iv:
                continue
            total = total + byol_pair_loss(q, v)
            n_terms += 1
    return ByolLossState(total / n_terms, std_s, std_t)


def frame_byol_loss(student, teacher, mask,
                    symmetric: bool = True) -> ByolLossState:
    """Frame-level loss (reference methods/atstframe/byol.py:57-84):
    student/teacher [2B, T, D] head outputs of both views, mask [2B, T]
    the selected positions (shared by the views). Symmetric: each
    student view is held against the other view's teacher output."""
    std_s = feature_std(l2_normalize(student), mask)
    std_t = feature_std(l2_normalize(teacher), mask)
    if not symmetric:
        return ByolLossState(byol_pair_loss(teacher, student, mask), std_s,
                             std_t)
    s_views = student.chunk(2, dim=0)
    t_views = teacher.chunk(2, dim=0)
    m_views = mask.chunk(2, dim=0)
    total, n_terms = 0.0, 0
    for iq, q in enumerate(t_views):
        for iv, v in enumerate(s_views):
            if iq == iv:
                continue
            total = total + byol_pair_loss(v, q, m_views[iv])
            n_terms += 1
    return ByolLossState(total / n_terms, std_s, std_t)
