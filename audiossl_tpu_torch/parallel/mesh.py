"""Data parallelism over ``torch.distributed`` (PyTorch port of
``audiossl_tpu/parallel/mesh.py``).

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
* ``reduce_grads`` / ``sum_tensors``: the gradients summed over ranks,
  in flat buckets;
* ``partition_leaves`` / ``broadcast_groups``: ZeRO-1's owners and the
  owners' updated leaves sent to every rank.

The downstream drivers (JAX's ``downstream_spmd``, ``maybe_shard_batch``)
keep every rank's loader on the whole global batch and take their rows of
it: ``shard_batch`` gives a rank its contiguous rows of a host batch, or
the whole batch with the group's reductions off (``replicated``) where
the rows do not divide over the ranks, so that the step equals one
process's; ``gather_rows`` runs a row-independent function (evaluation,
extraction) on a rank's rows of a padded batch and returns every row to
every rank; ``broadcast_object`` sends rank 0's value (a restored state)
to the others.

They use only ``all_reduce``, ``broadcast`` and list ``all_gather``, which
gloo supports on CUDA tensors as NCCL does, so two gloo ranks on one card
run the code that NCCL ranks run on several. With no process group (one
process) every helper is the identity and issues no collective.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Callable, Iterator, List, Optional, Sequence

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


_replicated = False  # inside ``replicated()``


def data_world() -> World:
    """The ranks a batch is split over: :func:`world`, or one rank inside
    :func:`replicated`. The reductions over the batch follow it."""
    return World() if _replicated else world()


@contextlib.contextmanager
def replicated():
    """Run the body on every rank's whole batch as one process runs it:
    the batch's rows and reductions (``local_rows``, ``all_reduce_sum``,
    ``all_gather_rows``, ``reduce_grads``, the global BatchNorm) are this
    rank's alone (JAX's replicated inputs under jit-SPMD)."""
    global _replicated
    before, _replicated = _replicated, True
    try:
        yield
    finally:
        _replicated = before


def global_batch_size(per_device: int) -> int:
    return per_device * data_world().size


def local_rows(n_global: int) -> slice:
    """This rank's contiguous slice of ``n_global`` rows."""
    w = data_world()
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
    if data_world().size == 1:
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` stacked along the first axis in rank order (no
    gradient)."""
    n = data_world().size
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
    if data_world().size == 1:
        return
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    sum_tensors([p.grad for p in leaves])


@torch.no_grad()
def sum_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over ranks, in place, through flat buckets (the
    gradients a step holds in a list)."""
    if data_world().size == 1:
        return
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        _scatter(flat, [tensors[i] for i in idx])


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


def _lead(v) -> Optional[int]:
    """The length of ``v``'s leading axis; None for a scalar or a
    string."""
    if isinstance(v, str) or not hasattr(v, "__len__"):
        return None
    return len(v) if getattr(v, "ndim", 1) else None


def batch_len(batch) -> int:
    """The rows of a batch dict: its values' common leading length."""
    leads = {x for x in map(_lead, batch.values()) if x is not None}
    if len(leads) != 1:
        raise ValueError(f"a batch's values have leading lengths {leads}")
    return leads.pop()


def _take(batch, rows):
    """``batch`` at the row indices ``rows`` (a slice or a list)."""
    def take(v):
        if _lead(v) is None or isinstance(rows, slice):
            return v if _lead(v) is None else v[rows]
        if isinstance(v, list):
            return [v[i] for i in rows]
        if isinstance(v, torch.Tensor):
            return v[torch.as_tensor(rows, device=v.device)]
        return v[rows]

    return {k: take(v) for k, v in batch.items()}


_warned_replicated = False


def shard_batch(batch) -> Optional[dict]:
    """This rank's contiguous rows of a host batch that every rank holds
    whole (``maybe_shard_batch`` under ``downstream_spmd``), or None
    when its rows do not divide over the ranks: the caller then runs the
    whole batch on every rank under :func:`replicated`. The first such
    batch prints a warning, as JAX's does."""
    global _warned_replicated
    n = data_world().size
    if n == 1:
        return batch
    b = batch_len(batch)
    if b % n == 0:
        return _take(batch, local_rows(b))
    if not _warned_replicated:
        _warned_replicated = True
        print(f"[parallel] batch of {b} rows not divisible by {n} ranks - "
              "running this (and similar) batches REPLICATED; pick a batch "
              "size divisible by the rank count for data-parallel speedup",
              flush=True)
    return None


@contextlib.contextmanager
def batch_rows(batch):
    """-> this rank's rows of ``batch`` (:func:`shard_batch`), the body
    run under :func:`replicated` with the whole batch where they do not
    divide."""
    local = shard_batch(batch)
    if local is not None:
        yield local
        return
    with replicated():
        yield batch


def gather_rows(fn: Callable, batch) -> Any:
    """``fn(rows)`` of a row-independent ``fn`` (a tensor or a tuple of
    tensors with the rows first) on every row of ``batch``, each rank
    running its share: the batch padded to a multiple of the ranks by
    repeating its last row, this rank's rows run, the results gathered in
    rank order and the padding dropped. One rank runs ``fn(batch)``."""
    w = data_world()
    if w.size == 1:
        return fn(batch)
    b = batch_len(batch)
    per = -(-b // w.size)
    rows = [min(i, b - 1) for i in range(w.rank * per, (w.rank + 1) * per)]
    out = fn(_take(batch, rows))
    many = isinstance(out, tuple)
    outs = tuple(all_gather_rows(o.contiguous())[:b]
                 for o in (out if many else (out,)))
    return outs if many else outs[0]


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (picklable) on every rank; ``obj`` itself
    with one rank."""
    if world().size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


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
