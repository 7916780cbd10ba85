"""Data parallelism over ``torch.distributed`` (PyTorch port of the
pretraining half of ``audiossl_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a device mesh: the batch is
sharded over the ``data`` axis, parameters and optimizer state are
replicated (or the Adam moments sharded: ZeRO-1), and every reduction
over the batch is global because XLA inserts the collectives. The port
runs one process a card, as the reference's Lightning DDP does, and makes
those reductions global by hand through the helpers here, all on the
default process group:

* ``all_reduce_sum``: a sum over ranks whose backward is the sum of the
  gradients over ranks (BatchNorm statistics, masked loss counts);
* ``all_gather_rows``: the global batch of an input (mixup's partners);
* ``reduce_grads``: the gradients summed over ranks, in flat buckets;
* ``partition_leaves`` / ``broadcast_groups``: ZeRO-1's owners and the
  owners' updated leaves sent to every rank.

They use only ``all_reduce``, ``broadcast`` and list ``all_gather``, which
gloo supports on CUDA tensors as NCCL does, so two gloo ranks on one card
run the code that NCCL ranks run on several. With no process group (one
process) every helper is the identity and issues no collective.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from audiossl_tpu_torch.kernels.build import resolve_device

BUCKET_BYTES = 64 << 20  # the most one flat collective carries
TIMEOUT = datetime.timedelta(minutes=5)  # a collective that waits longer
# raises (a rank that died or hangs)


@dataclasses.dataclass(frozen=True)
class World:
    """This process's rank and the group's size."""
    rank: int = 0
    size: int = 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def world() -> World:
    """The default process group's rank and size; (0, 1) with none."""
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size())
    return World()


def global_batch_size(per_device: int) -> int:
    return per_device * world().size


def local_rows(n_global: int) -> slice:
    """This rank's contiguous slice of ``n_global`` rows."""
    w = world()
    if n_global % w.size:
        raise ValueError(f"{n_global} rows do not divide over {w.size} "
                         "ranks")
    b = n_global // w.size
    return slice(w.rank * b, (w.rank + 1) * b)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, on every rank. Differentiable: the
    gradient of ``x`` on a rank is the sum over ranks of the gradient of
    the result, so a loss that is the sum of the ranks' losses gets its
    global gradient."""
    if world().size == 1:
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` stacked along the first axis in rank order (no
    gradient)."""
    n = world().size
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, 0)


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[int]]:
    """Indices of ``tensors`` in runs of one dtype and at most
    ``BUCKET_BYTES`` (a larger tensor goes alone)."""
    run, size = [], 0
    for i, t in enumerate(tensors):
        nb = t.numel() * t.element_size()
        if run and (t.dtype != tensors[run[0]].dtype
                    or size + nb > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(i)
        size += nb
    if run:
        yield run


@torch.no_grad()
def reduce_grads(leaves: Sequence[torch.Tensor]) -> None:
    """Sum every leaf's gradient over ranks, in place, through flat
    buckets (a leaf without one gets zeros first, so every rank sends the
    same layout)."""
    if world().size == 1:
        return
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in leaves]
    for idx in _buckets(grads):
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        _scatter(flat, [grads[i] for i in idx])


def _scatter(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    parts = flat.split([t.numel() for t in tensors])
    for t, part in zip(tensors, parts):
        t.copy_(part.view_as(t))


def partition_leaves(sizes: Sequence[int], n: int) -> List[int]:
    """The owning rank of each leaf (whole leaves) for ZeRO-1, as
    ``ZeroRedundancyOptimizer`` partitions: largest first, each to the
    rank with the fewest bytes so far (the lowest such rank)."""
    owner, load = [0] * len(sizes), [0] * n
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        r = min(range(n), key=load.__getitem__)
        owner[i] = r
        load[r] += sizes[i]
    return owner


@torch.no_grad()
def broadcast_groups(groups: Sequence[Sequence[torch.Tensor]]) -> None:
    """Rank r sends ``groups[r]`` to every rank, in flat buckets; the
    other ranks' copies are overwritten in place."""
    w = world()
    if w.size == 1:
        return
    for src, tensors in enumerate(groups):
        for idx in _buckets(tensors):
            part = [tensors[i] for i in idx]
            if w.rank == src:
                flat = torch.cat([t.reshape(-1) for t in part])
            else:
                flat = torch.empty(sum(t.numel() for t in part),
                                   dtype=part[0].dtype,
                                   device=part[0].device)
            dist.broadcast(flat, src)
            if w.rank != src:
                _scatter(flat, part)


def init_from_env(device="cuda",
                  backend: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: ``cuda:LOCAL_RANK``
    for ``"cuda"`` (a device with an index stays as it is), the CPU for
    ``"cpu"``. The backend is NCCL for a CUDA device and gloo for the
    CPU unless ``backend`` names one."""
    env = os.environ
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        resolve_device(dev)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://", rank=int(env["RANK"]),
        world_size=int(env["WORLD_SIZE"]), timeout=TIMEOUT)
    return dev


def in_launcher_env() -> bool:
    """Whether torchrun's variables describe a group to join."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))
