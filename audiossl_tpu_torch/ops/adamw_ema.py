"""Fused AdamW + EMA-teacher update, in place (kernel K7).

Port of ``audiossl_tpu/ops/pallas_opt.py:150 fused_adamw_ema_pallas`` (math
``leaf_update :61``) and of ``training/pretrain.py:130 fused_adamw_ema``.
Per leaf, in f32::

    mu' = b1 mu + (1 - b1) g
    nu' = b2 nu + (1 - b2) g^2
    u   = (mu' rc1) / (sqrt(nu' rc2) + eps) + wd_eff p
    p'  = p - lr u
    t'  = m t + (1 - m) p'          (leaves the teacher holds)

``rc1 = 1 / (1 - b1^count)`` and ``rc2 = 1 / (1 - b2^count)`` are the bias
corrections of the already incremented step count; ``wd_eff`` is ``wd``
where the leaf decays (``ndim >= 2``), else 0. Parameters, moments and
teacher leaves are updated in place (the JAX version aliases its outputs
to its inputs, which the step donates).

On a CUDA device the whole update is one launch of ``csrc/adamw_ema.cu``
over every leaf; :func:`adamw_ema_ref` is its plain version, taken for CPU
tensors. Both round each operation on its own in the same order, so they
agree bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from audiossl_tpu_torch.kernels import build as kb

CHUNK = 4096  # elements per block of the kernel (csrc/adamw_ema.cu)


def update_scalars(lr, wd, m, count: int, b1: float, b2: float,
                   eps: float) -> dict:
    """The update's scalars as f32 values (Python floats that are exact
    f32): the schedule values and the bias corrections of ``count``."""
    f = np.float32
    one = f(1.0)
    return {k: float(v) for k, v in dict(
        lr=f(lr), wd=f(wd), m=f(m), one_minus_m=one - f(m),
        rc1=one / (one - f(b1) ** f(count)),
        rc2=one / (one - f(b2) ** f(count)),
        b1=f(b1), one_minus_b1=f(1.0 - b1), b2=f(b2),
        one_minus_b2=f(1.0 - b2), eps=f(eps)).items()}


@torch.no_grad()
def adamw_ema_ref(params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor],
                  mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                  teacher: Sequence[Optional[torch.Tensor]],
                  decay: Sequence[bool], sc: dict) -> None:
    """Plain version of :func:`adamw_ema`, leaf by leaf, in place; ``sc``
    from :func:`update_scalars`."""
    for p, g, m1, m2, t, dec in zip(params, grads, mu, nu, teacher, decay):
        m1.mul_(sc["b1"]).add_(g * sc["one_minus_b1"])
        m2.mul_(sc["b2"]).add_((g * g).mul_(sc["one_minus_b2"]))
        u = (m1 * sc["rc1"]) / (torch.sqrt(m2 * sc["rc2"]) + sc["eps"])
        if dec:
            u = u + p * sc["wd"]
        p.sub_(u * sc["lr"])
        if t is not None:
            t.mul_(sc["m"]).add_(p * sc["one_minus_m"])


def _leaf_table(params, grads, mu, nu, teacher, decay):
    """[L, 8] int64 records of csrc/adamw_ema.cu's Leaf: five pointers,
    the length, the first chunk, the f32 weight-decay flag."""
    rows: List[List[int]] = []
    chunk0 = 0
    for p, g, m1, m2, t, dec in zip(params, grads, mu, nu, teacher, decay):
        n = p.numel()
        wd_bits = int(np.float32(1.0 if dec else 0.0).view(np.int32))
        rows.append([p.data_ptr(), g.data_ptr(), m1.data_ptr(),
                     m2.data_ptr(), 0 if t is None else t.data_ptr(), n,
                     chunk0, wd_bits])
        chunk0 += (n + CHUNK - 1) // CHUNK
    return np.asarray(rows, np.uint64).view(np.int64), chunk0


@torch.no_grad()
def adamw_ema(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
              teacher: Sequence[Optional[torch.Tensor]],
              decay: Sequence[bool], sc: dict) -> None:
    """AdamW + EMA over all leaves, in place. Leaf i: parameter params[i],
    its gradient, its Adam moments, its teacher copy (or None) and whether
    it decays; all f32 and of one shape per leaf. ``sc`` from
    :func:`update_scalars`."""
    if params[0].device.type == "cpu":
        return adamw_ema_ref(params, grads, mu, nu, teacher, decay, sc)
    leaves = [t for t in (*params, *grads, *mu, *nu, *teacher)
              if t is not None]
    kb.require_cuda("adamw_ema", *leaves)
    if any(t.dtype != torch.float32 for t in leaves):
        raise ValueError("adamw_ema: every state tensor must be f32")
    for p, g, m1, m2, t in zip(params, grads, mu, nu, teacher):
        if any(x.shape != p.shape for x in (g, m1, m2) + (
                () if t is None else (t,))):
            raise ValueError(f"adamw_ema: shapes differ for a leaf of shape "
                             f"{tuple(p.shape)}")
    table, n_chunks = _leaf_table(params, grads, mu, nu, teacher, decay)
    dev = params[0].device
    table_dev = torch.from_numpy(table).to(dev)
    kb.launch("adamw_ema", dev, kb.ptr(table_dev), len(params), n_chunks,
              sc["lr"], sc["wd"], sc["m"], sc["one_minus_m"], sc["rc1"],
              sc["rc2"], sc["b1"], sc["one_minus_b1"], sc["b2"],
              sc["one_minus_b2"], sc["eps"])
