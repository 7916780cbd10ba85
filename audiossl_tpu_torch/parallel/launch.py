"""Starting the ranks of a data-parallel run on one host.

A run joins a group one of three ways: under torchrun (its environment
names the group), as ranks that :func:`spawn` starts here (the ``spawn``
start method, never ``fork``: a rank may touch CUDA, and a forked CUDA
context is unusable), or as one process with no group. :func:`run_cli` is
the pretraining CLIs' ``--n_devices`` on top of these.
"""
from __future__ import annotations

import os
import socket
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from audiossl_tpu_torch.parallel import mesh


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(index: int, fn: Callable, args: Sequence, n: int, port: int,
          device: str, backend: Optional[str]) -> None:
    os.environ.update(RANK=str(index), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(index), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mesh.init_from_env(device, backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (), device="cuda",
          backend: Optional[str] = None,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(*args)`` on ``n`` ranks started here, each in a group on
    a free local port (``mesh.init_from_env``: ``cuda:rank`` for
    ``"cuda"``, the default, the same card for every rank for
    ``"cuda:k"``; ``"cpu"`` on the host). Raises
    when a rank fails (the others are stopped) or, with ``timeout_s``,
    when the ranks have not all ended by then; no rank outlives the
    call. ``fn`` must be importable by name (a module-level function)."""
    ctx = mp.start_processes(
        _rank, args=(fn, tuple(args), n, free_port(), str(device), backend),
        nprocs=n, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the {n} ranks did not end within "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def rank_device(device) -> torch.device:
    """This rank's device: the current card for a CUDA ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_ranks(device) -> int:
    """The ranks a CLI runs on when ``--n_devices`` is not given: the
    launcher's ``WORLD_SIZE``, else every visible card for a CUDA device
    (as JAX's ``len(jax.devices())``), else 1."""
    if mesh.in_launcher_env():
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def run_cli(train: Callable, args):
    """``train(args)`` on ``args.n_devices`` ranks (None:
    :func:`default_ranks`), with ``args.n_devices`` set to that count and
    ``args.device`` to the rank's device. Under torchrun this process
    joins its group; otherwise one rank runs here with no group, or the
    ranks are spawned (the kernels built first, once, for a card).
    Returns ``train``'s result, or None where the ranks were spawned."""
    if mesh.in_launcher_env() and not dist.is_initialized():
        n = int(os.environ["WORLD_SIZE"])
        if args.n_devices not in (None, n):
            raise ValueError(f"--n_devices {args.n_devices} but the launcher "
                             f"started {n} ranks")
        args.n_devices = n
        args.device = str(mesh.init_from_env(args.device))
        try:
            return train(args)
        finally:
            dist.destroy_process_group()
    n = args.n_devices or default_ranks(args.device)
    args.n_devices = n
    if dist.is_initialized():
        if n != mesh.world().size:
            raise ValueError(f"--n_devices {n} in a group of "
                             f"{mesh.world().size} ranks")
        return train(args)
    if n == 1:
        return train(args)
    if torch.device(args.device).type == "cuda":
        from audiossl_tpu_torch.kernels import build as kb

        kb.resolve_device(args.device)
        if torch.cuda.device_count() < n:
            raise ValueError(f"--n_devices {n} needs {n} cards; "
                             f"{torch.cuda.device_count()} visible")
        kb.library()  # built once, before the ranks load it
    spawn(_cli_rank, n, (train, args), device=args.device)
    return None


def add_n_devices(parser) -> None:
    """The CLIs' ``--n_devices`` flag (:func:`run_cli` reads it)."""
    parser.add_argument(
        "--n_devices", type=int, default=None,
        help="data-parallel ranks, one a card (default: every visible "
             "card, or the launcher's WORLD_SIZE; 1 for --device cpu); "
             "without torchrun the CLI starts them")


def print0(*args, **kw) -> None:
    """``print`` on rank 0 alone."""
    if mesh.world().is_main:
        print(*args, **kw)


def _cli_rank(train: Callable, args) -> None:
    args.device = str(rank_device(args.device))
    train(args)
