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
agree bit for bit. The kernel reads its leaves from a device table
(:class:`LeafTable`) that is built once per set of leaves; per call only
the gradients' pointers are uploaded, from pinned memory, so the launch
path never waits for the device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from audiossl_tpu_torch.kernels import build as kb

CHUNK = 2048  # elements per chunk of the kernel (csrc/adamw_ema.cu)


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


def leaf_records(params, mu, nu, teacher, decay):
    """csrc/adamw_ema.cu's table for these leaves, as int64 words: per leaf
    a 48-byte ``Leaf`` record (the pointers of p, mu, nu and the teacher's
    copy or 0, the length, the first chunk and the f32 decay flag packed in
    one word), then the chunk -> leaf map as int32 (two a word); and the
    number of chunks. Each leaf starts on a chunk of its own."""
    n = np.array([p.numel() for p in params], np.int64)
    chunks = (n + CHUNK - 1) // CHUNK
    chunk0 = np.concatenate([[0], np.cumsum(chunks)[:-1]]).astype(np.int64)
    n_chunks = int(chunks.sum())
    if n_chunks >= 2 ** 31:
        raise ValueError(f"adamw_ema: {n_chunks} chunks exceed the kernel's "
                         "int32 chunk index")
    wd_bits = np.array(decay, np.float32).view(np.int32).astype(np.int64)
    rec = np.empty((len(params), 6), np.int64)
    rec[:, 0] = [p.data_ptr() for p in params]
    rec[:, 1] = [x.data_ptr() for x in mu]
    rec[:, 2] = [x.data_ptr() for x in nu]
    rec[:, 3] = [0 if t is None else t.data_ptr() for t in teacher]
    rec[:, 4] = n
    rec[:, 5] = chunk0 | (wd_bits << 32)
    leaf_of = np.repeat(np.arange(len(params), dtype=np.int32), chunks)
    if n_chunks % 2:
        leaf_of = np.append(leaf_of, np.int32(0))
    return np.concatenate([rec.ravel(), leaf_of.view(np.int64)]), n_chunks


def to_device(words: np.ndarray, out: torch.Tensor) -> None:
    """Copies int64 ``words`` into the device tensor ``out`` without a
    synchronization: through a pinned buffer of PyTorch's host allocator,
    ordered on the current stream. The allocator hands that buffer out
    again only once the copy has completed, so the host may fill the next
    one while this one is in flight."""
    host = torch.empty(words.shape, dtype=torch.int64, pin_memory=True)
    host.numpy()[...] = words
    out.copy_(host, non_blocking=True)


class LeafTable:
    """K7's device table for one set of leaves, kept between calls: built
    and uploaded when the leaves' pointers, lengths or decay flags differ
    from the last call's, else reused as it is (``table``, ``grads`` and
    ``n_chunks`` stay the same objects). ``grads``, the gradients' pointers,
    is rewritten on every call, ordered after the last launch that read it
    by the stream: calls that share a table run on one stream."""

    def __init__(self):
        self.key = None
        self.table: Optional[torch.Tensor] = None
        self.grads: Optional[torch.Tensor] = None
        self.n_chunks = 0

    def refresh(self, params, mu, nu, teacher, decay) -> None:
        """Rebuilds the table if the leaves changed (the checks of the
        kernel path run then)."""
        key = ([t.data_ptr() for t in (*params, *mu, *nu)],
               [0 if t is None else t.data_ptr() for t in teacher],
               [p.numel() for p in params], list(decay))
        if key == self.key:
            return
        _check_leaves(params, mu, nu, teacher)
        words, n_chunks = leaf_records(params, mu, nu, teacher, decay)
        dev = params[0].device
        table = torch.empty(words.shape, dtype=torch.int64, device=dev)
        to_device(words, table)
        self.key, self.table, self.n_chunks = key, table, n_chunks
        self.grads = torch.empty(len(params), dtype=torch.int64, device=dev)


def _check_leaves(params, mu, nu, teacher):
    leaves = [t for t in (*params, *mu, *nu, *teacher) if t is not None]
    kb.require_cuda("adamw_ema", *leaves)
    if any(t.dtype != torch.float32 for t in leaves):
        raise ValueError("adamw_ema: every state tensor must be f32")
    for p, m1, m2, t in zip(params, mu, nu, teacher):
        if any(x.shape != p.shape for x in (m1, m2) + (
                () if t is None else (t,))):
            raise ValueError(f"adamw_ema: shapes differ for a leaf of shape "
                             f"{tuple(p.shape)}")


@torch.no_grad()
def adamw_ema(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
              teacher: Sequence[Optional[torch.Tensor]],
              decay: Sequence[bool], sc: dict, table: LeafTable) -> None:
    """AdamW + EMA over all leaves, in place. Leaf i: parameter params[i],
    its gradient, its Adam moments, its teacher copy (or None) and whether
    it decays; all f32 and of one shape per leaf. ``sc`` from
    :func:`update_scalars`. ``table`` keeps the kernel's leaf table
    between calls: a caller that updates the same leaves every step passes
    the same one. No call synchronizes the host with the device."""
    if params[0].device.type == "cpu":
        return adamw_ema_ref(params, grads, mu, nu, teacher, decay, sc)
    table.refresh(params, mu, nu, teacher, decay)
    kb.require_cuda("adamw_ema", params[0], *grads)
    if any(g.dtype != torch.float32 or g.numel() != p.numel()
           for p, g in zip(params, grads)):
        raise ValueError("adamw_ema: every gradient must be f32 and of its "
                         "parameter's shape")
    to_device(np.array([g.data_ptr() for g in grads], np.int64), table.grads)
    kb.launch("adamw_ema", params[0].device, kb.ptr(table.table),
              kb.ptr(table.grads), len(params), table.n_chunks,
              sc["lr"], sc["wd"], sc["m"], sc["one_minus_m"], sc["rc1"],
              sc["rc2"], sc["b1"], sc["one_minus_b1"], sc["b2"],
              sc["one_minus_b2"], sc["eps"])
