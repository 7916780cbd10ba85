"""LayerNorm whose backward is one pass over (x, dy) (kernel K8).

Port of ``audiossl_tpu/ops/pallas_ln.py:132 layer_norm``, the norm of
``LayerNormPG``. The forward is plain PyTorch with the JAX package's math
(``_ln_fwd_math``): f32 statistics with the *fast* variance
``max(mean(x^2) - mu^2, 0)`` (flax's, not ``F.layer_norm``'s two-pass
variance), the f32 affine, the result cast to ``dtype``. The backward is
K8 (``csrc/ln_pg.cu``): per row it recomputes mu and rstd with the same
fast variance and gives dx in x's dtype; dscale and dbias are f32 sums over
all rows (``_bwd_block``), which the kernel gives as per-block partial sums
added in a fixed order by a second small launch (the same sums on every
run). The incoming gradient is cast to x's dtype first, as the Pallas path
casts it.

:func:`ln_bwd` takes its plain version :func:`ln_bwd_ref` for a CPU tensor
and launches the kernel for a CUDA tensor.
"""
from __future__ import annotations

import functools

import torch

from audiossl_tpu_torch.kernels import build as kb


def _stats(xf, eps):
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    return mu, torch.rsqrt(var + eps)


def ln_forward(x, scale, bias, eps: float, dtype: torch.dtype):
    """The forward: x [..., C] -> [..., C] in ``dtype``."""
    xf = x.float()
    mu, rstd = _stats(xf, eps)
    return ((xf - mu) * rstd * scale.float() + bias.float()).to(dtype)


def ln_bwd_ref(x, dy, scale, eps: float):
    """Plain version of :func:`ln_bwd`."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).float()
    gf = dy.reshape(-1, C).float()
    mu, rstd = _stats(xf, eps)
    xhat = (xf - mu) * rstd
    dxhat = gf * scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape), (gf * xhat).sum(dim=0),
            gf.sum(dim=0))


BLOCKS_PER_SM = 2  # blocks of csrc/ln_pg.cu's row kernel on each SM
ROWS_PER_BLOCK = 8  # rows a block takes at a time, at least (one a warp)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_blocks(device: torch.device, rows: int) -> int:
    """Blocks of K8's row kernel for ``rows`` rows: a few an SM, none
    without a row; each writes one row of the partial column sums."""
    return max(1, min(BLOCKS_PER_SM * _sm_count(device),
                      -(-rows // ROWS_PER_BLOCK)))


def ln_bwd(x, dy, scale, eps: float):
    """x, dy [..., C] in one dtype (f32 or bf16), C <= 1024; scale [C] f32.
    Returns (dx in x's dtype, dscale [C] f32, dbias [C] f32)."""
    if x.device.type == "cpu":
        return ln_bwd_ref(x, dy, scale, eps)
    C = x.shape[-1]
    if x.dtype not in kb.DTYPE_CODES or dy.dtype != x.dtype:
        raise ValueError("ln_bwd: x and dy must both be f32 or both bf16")
    if C > 1024 or scale.dtype != torch.float32:
        raise ValueError(f"ln_bwd: width {C} must be <= 1024 and scale f32")
    x2 = x.reshape(-1, C).contiguous()
    g2 = dy.reshape(-1, C).contiguous()
    kb.require_cuda("ln_bwd", x2, g2, scale)
    blocks = grid_blocks(x.device, x2.shape[0])
    dx = torch.empty_like(x2)
    # each block's column sums, added in a fixed order by the second launch
    partial = torch.empty(blocks, 2, C, device=x.device, dtype=torch.float32)
    dsb = torch.empty(2, C, device=x.device, dtype=torch.float32)
    kb.launch("ln_pg_bwd", x.device,
              *map(kb.ptr, (x2, g2, scale, dx, partial, dsb)), blocks,
              kb.DTYPE_CODES[x.dtype], x2.shape[0], C, eps)
    return dx.reshape(x.shape), dsb[0], dsb[1]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, dtype, plain):
        ctx.save_for_backward(x, scale)
        ctx.cfg = (eps, plain)
        return ln_forward(x, scale, bias, eps, dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        eps, plain = ctx.cfg
        bwd = ln_bwd_ref if plain else ln_bwd
        dx, ds, db = bwd(x, g.to(x.dtype).contiguous(), scale, eps)
        return dx, ds.to(scale.dtype), db.to(scale.dtype), None, None, None


def layer_norm(x, scale, bias, eps: float = 1e-6,
               dtype: torch.dtype = torch.float32, plain: bool = False):
    """LayerNorm of x [..., C] with the fast-variance forward, output in
    ``dtype``, and gradients to x, scale and bias. ``plain=True`` runs the
    backward's plain version on any device."""
    return _LayerNorm.apply(x, scale, bias, eps, dtype, plain)
