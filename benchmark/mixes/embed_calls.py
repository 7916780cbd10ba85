"""The bulk scene-embedding traffic: ``get_scene_embedding`` on the
encoder ``load_model`` builds, one client in a closed loop.

Set-up writes the harness's weights as a checkpoint under ``TMPDIR`` (bf16
values, so the file is half the size and loads to the same f32 weights),
loads it with ``load_model(fused=True)`` and deletes it. Each call hands in
a float32 batch in pinned host memory, as ``DataLoader(pin_memory=True)``
gives it, and ends with the embeddings on the host; the call is timed from
handing in the batch to the host copy of its result. The client then lets
the answer go, as a streaming client does, so that the next call's result
lands in host memory already mapped: an answer kept alive in the program's
own buffer makes every later call fault in fresh pages, a cost of the
judge's and not of the call. The judge's sample is one call in each block of
``judge_every``, at an offset drawn from the seed; its answer is copied
into host memory made and touched in set-up. After the window the reference
embeds the pool's clips once, and every answer of every sampled call is held
against it.

Traffic keys: ``batch``, ``pool``, ``clip_s``, ``warmup_calls``,
``judge_every``, ``profile_calls``.
"""
from __future__ import annotations

import math
import os
import tempfile
import time

import torch

from harness import audio, roofline, stats, trace, weights
from harness.context import Ctx, Outcome, free, peak_bytes, reset_peak, sync
from reference import atst as ref


def run(ctx: Ctx) -> Outcome:
    from audiossl_tpu_torch.embedding import get_scene_embedding, load_model

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    enc_shapes = weights.encoder_shapes(c, cls=False)
    w = weights.draw(enc_shapes, ctx.seed, dev, round_bf16=True)
    fd, path = tempfile.mkstemp(suffix=".ckpt")
    os.close(fd)
    try:
        torch.save({"state_dict": {"model.teacher.encoder." + k:
                                   v.to(torch.bfloat16).cpu()
                                   for k, v in w.items()}}, path)
        quant = c["control"].get("serve_quant", "none") if ctx.control \
            else "none"
        model = load_model(path, arch=c["arch"], fused=True, device=dev,
                           quant=quant)
    finally:
        os.remove(path)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    n = int(tr["clip_s"] * 16000)
    pool = []
    for _ in range(tr["pool"]):
        host = torch.empty(tr["batch"], n, pin_memory=dev.type == "cuda")
        host.copy_(audio.clips(gen, tr["batch"], n, dev))
        pool.append(host)
    for i in range(tr["warmup_calls"]):
        t_call = time.perf_counter()
        e = get_scene_embedding(pool[i % len(pool)], model).cpu()
        t_call = time.perf_counter() - t_call
    every = tr["judge_every"]
    cap = math.ceil(1.5 * ctx.seconds / t_call / every) + 1
    store = torch.zeros((cap,) + tuple(e.shape), dtype=e.dtype)
    offs = torch.randint(every, (cap,), generator=torch.Generator()
                         .manual_seed(ctx.seed + 2)).tolist()
    del e
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    judged, lat = [], []  # (call index, answer) of the judge's sample

    def one(i):
        t0 = time.perf_counter()
        e = get_scene_embedding(pool[i % len(pool)], model).cpu()
        lat.append(time.perf_counter() - t0)
        blk, off = divmod(i, every)
        if off == offs[blk % cap]:
            j = len(judged)
            fits = j < cap and e.shape == store.shape[1:]
            judged.append((i, store[j].copy_(e) if fits else e))

    out = Outcome(setup_s=setup_s, attempted=0, failed=0, e2e={},
                  memory_peak_bytes=0, numbers={})
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < ctx.seconds:
        one(k)
        k += 1
    secs = time.perf_counter() - t0
    out.attempted = k
    out.failed = sum(int(not torch.isfinite(e).all()) for _, e in judged)
    if ctx.trace:
        out.unit_s = secs / k
        out.unit_flops = roofline.frame_embed_call_flops(c, tr)
        out.peak_flops = roofline.PEAK_FLOPS[c["peak"]]
        j = [k]

        def traced():
            one(j[0])
            j[0] += 1

        out.traces = [trace.profile_units(traced, tr["profile_calls"])]
        out.bound_ctx = {"mel_band": roofline.mel_band(ref.mel_filterbank())}
    else:
        out.e2e["embed_clips_per_s"] = k * tr["batch"] / secs
        out.e2e["embed_call_p95_ms"] = stats.percentile(lat, 95) * 1e3
    out.memory_peak_bytes = peak_bytes(dev)
    del model
    free(dev)
    out.numbers = reference_numbers(ctx, w, pool, judged)
    return out


def reference_numbers(ctx, w, pool, judged):
    """The worst row, over every answer of every sampled call, of the
    relative L2 gap between the program's embedding and the reference's."""
    c = ctx.config
    with ref.strict_f32():
        want = []
        for host in pool:
            rows = []
            for i in range(0, host.shape[0], 32):  # in blocks of rows
                x = host[i:i + 32].to(ctx.device)
                rows.append(ref.scene_embedding(w, x, c["num_heads"],
                                                c["num_layers"],
                                                c["serve_blocks"],
                                                c["serve_chunk_frames"]).cpu())
            want.append(torch.cat(rows).double())
    if not judged:  # nothing was judged: no answer stands
        return {"embed_gap": float("inf")}
    worst = 0.0
    for i, got in judged:
        exp = want[i % len(pool)]
        if got.shape != exp.shape:
            return {"embed_gap": 1.0}
        gap = (got.double() - exp).norm(dim=-1) / exp.norm(dim=-1)
        if not bool(torch.isfinite(gap).all()):
            return {"embed_gap": float("inf")}
        worst = max(worst, float(gap.max()))
    return {"embed_gap": worst}
