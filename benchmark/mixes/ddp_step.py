"""The data-parallel ATST-Frame pretraining traffic: the recipe's
step on ``ranks`` cards, one rank a card over NCCL, started as the CLIs'
``--n_devices`` starts them (``parallel.launch.spawn``), closed loop.

Every rank builds the same method and state from the seed, draws the same
global batches and draws, and steps on its rows of each batch with the
global batch's draws; the step sums the gradients over the ranks. Rank 0's
first three steps are what the reference follows, on the global batch in
one process. The window is a fixed number of steps, the one that fills
``--seconds`` at the rate of two timed warm-up steps, agreed by all ranks
before it opens, so that every rank runs the same work; it lasts from the
barrier before the first step to the slowest rank's end. Each rank writes
what it read to a file the parent process collects.

Traffic keys: ``ranks``, ``batch`` (clips a rank), ``pool``,
``check_steps``, ``profile_steps``.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import time

import torch

from harness import roofline, trace, weights
from harness.context import Ctx, Outcome, free, reset_peak, sync
from mixes import pretrain_step as ps


def rank(ctx: Ctx, outdir: str) -> None:
    """One rank's run (``parallel.launch.spawn`` calls it in a group)."""
    import torch.distributed as dist

    from audiossl_tpu_torch.parallel.launch import rank_device
    from harness import faults

    dev = rank_device(ctx.device.type)
    cm = (faults.planted("ddp_step", ctx.fault) if ctx.fault
          else contextlib.nullcontext())
    with cm:
        res = _rank_run(ctx, dev, dist.get_rank(), dist.get_world_size())
    with open(os.path.join(outdir, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _rank_run(ctx: Ctx, dev, r: int, n: int) -> dict:
    import torch.distributed as dist

    c, tr = ctx.config, ctx.traffic
    B = tr["batch"]
    method, state, step, _ = ps.build_state(ctx, dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    rows = slice(r * B, (r + 1) * B)
    rate = c["pretrain"]["drop_path_rate"]
    feed = []
    for _ in range(tr["pool"]):
        b, d = ps.draw_inputs(gen, c, B * n, dev)
        feed.append(({k: v[rows].contiguous() for k, v in b.items()},
                     ps.step_draws(d, rate)))
    readings = ps.first_steps(state, step, feed, tr["check_steps"])
    sync(dev)
    t = time.perf_counter()
    for i in range(2):  # timed warm-up: the window's length in steps
        step(state, *feed[i])
    sync(dev)
    steps = torch.tensor([max(3, round(ctx.seconds * 2 / (
        time.perf_counter() - t)))], device=dev)
    dist.broadcast(steps, 0)
    steps = int(steps)
    setup_end = time.perf_counter()

    losses = []

    def one(i):
        losses.append(step(state, *feed[i % len(feed)])["loss"])

    reset_peak(dev)
    dist.barrier()
    sync(dev)
    t = time.perf_counter()
    for i in range(steps):
        one(i)
    sync(dev)
    elapsed = torch.tensor([time.perf_counter() - t], device=dev,
                           dtype=torch.float64)
    dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
    res = {"setup_end": setup_end, "steps": steps, "elapsed": float(elapsed),
           "failed": int((~torch.isfinite(torch.stack(losses))).sum()),
           "peak": (int(torch.cuda.max_memory_allocated(dev))
                    if dev.type == "cuda" else 0),
           "readings": readings if r == 0 else None}
    if ctx.trace:
        k = [steps]

        def traced():
            one(k[0])
            k[0] += 1

        res["trace"] = trace.profile_units(traced, tr["profile_steps"])
        res["bound_ctx"] = ps.bound_context(state)
    return res


def run(ctx: Ctx) -> Outcome:
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.parallel.launch import spawn
    from mixes import ddp_step

    c, tr = ctx.config, ctx.traffic
    n, B = tr["ranks"], tr["batch"]
    if ctx.device.type == "cuda":
        kb.library()  # built once, before the ranks load it
    outdir = tempfile.mkdtemp(prefix="bench_ranks_")
    try:
        spawn(ddp_step.rank, n, (ctx, outdir), device=ctx.device.type,
              timeout_s=tr["rank_timeout_s"])
        res = []
        for r in range(n):
            with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    r0 = res[0]
    out = Outcome(setup_s=max(x["setup_end"] for x in res) - ctx.t0,
                  attempted=r0["steps"], failed=max(x["failed"] for x in res),
                  e2e={}, memory_peak_bytes=max(x["peak"] for x in res),
                  numbers={})
    if ctx.trace:
        out.unit_s = r0["elapsed"] / r0["steps"]
        out.unit_flops = roofline.frame_pretrain_step_flops(c, B * n)
        out.peak_flops = roofline.PEAK_FLOPS[c["peak"]] * n
        out.traces = [x["trace"] for x in res]
        out.bound_ctx = r0["bound_ctx"]
    else:
        out.e2e["train_clips_per_s"] = r0["steps"] * B * n / r0["elapsed"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    inputs = [ps.draw_inputs(gen, c, B * n, ctx.device)
              for _ in range(tr["check_steps"])]
    w = weights.draw(weights.frame_branch_shapes(c, predictor=True),
                     ctx.seed, ctx.device)
    out.numbers = ps.reference_numbers(ctx, w, inputs, r0["readings"])
    del w, inputs
    free(ctx.device)  # the card's memory back before other ranks start
    return out
