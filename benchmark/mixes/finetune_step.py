"""The AudioSet finetuning traffic: ``FinetuneTask.train_step`` as
``train_finetune`` builds it from the AudioSet recipe's flags, closed loop.

The encoder is built as ``train_freeze.load_encoder`` builds a checkpoint's
(the f32 module route, 1001 frames of position embeddings) and takes the
harness's weights; the task is ``train_finetune.build_task``'s from the
recipe's command line. Batches come as the loader gives them: host arrays
of clips padded to the crop, their valid counts and multi-hot labels. Set-up
drives the state through its first three steps on distinct clips, which
the reference follows (each step's loss, each leaf's first clipped
gradient, the momentum trace after one step, and each leaf's change after
three); the window then cycles through a pool of batches.

Traffic keys: ``batch``, ``pool``, ``crop_s`` (the buffer and crop),
``clip_s`` (audio in a clip), ``num_labels``, ``check_steps``,
``profile_steps``, ``recipe_flags``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import audio, compare, roofline, trace, weights
from harness.context import (Ctx, Outcome, closed_loop, free, peak_bytes,
                             reset_peak, sync)
from reference import atst as ref


def clip_shapes(c: dict, tr: dict):
    s = {"encoder." + k: v for k, v in weights.encoder_shapes(c, cls=True).items()}
    d = 2 * c["head_blocks"] * c["hidden_size"]
    s["head.linear.weight"] = (tr["num_labels"], d)
    s["head.linear.bias"] = (tr["num_labels"],)
    return s


def draw_inputs(gen, c: dict, tr: dict, rows: int, device, rng):
    B = tr["batch"]
    pad = int(tr["crop_s"] * 16000)
    n = int(tr["clip_s"] * 16000)
    wav = torch.zeros(B, pad, device=device)
    wav[:, :n] = audio.clips(gen, B, n, device)
    label = audio.multi_hot(gen, B, tr["num_labels"], device)
    lam = torch.from_numpy(rng.beta(tr["mixup_alpha"], tr["mixup_alpha"], B)
                           .astype(np.float32)).to(device)
    shift = int(torch.randint(1, B, (), generator=gen, device=device))
    dp_u = torch.rand(c["num_layers"], 2, rows, generator=gen, device=device)
    batch = {"wav": wav.cpu().numpy(),
             "valid": np.full((B,), n, dtype=np.int64),
             "label": label.cpu().numpy()}
    return batch, {"lam": lam, "shift": shift, "dp_u": dp_u}


def build(ctx: Ctx, w):
    from audiossl_tpu_torch.compat.checkpoint import load_encoder_state
    from audiossl_tpu_torch.datasets import get_dataset
    from audiossl_tpu_torch.downstream.train_finetune import (build_parser,
                                                              build_task)
    from audiossl_tpu_torch.models import atst

    c, tr = ctx.config, ctx.traffic
    args = build_parser().parse_args(
        ["--pretrained_ckpt_path", "seeded.ckpt", "--data_path", "-"]
        + tr["recipe_flags"])
    enc = getattr(atst, c["encoder"])(spec_w=c["pos_frames"],
                                              device="meta")
    load_encoder_state(enc, {k[8:]: v.clone() for k, v in w.items()
                             if k.startswith("encoder.")},
                       assign=True, layout="port")
    enc.requires_grad_(False)
    enc = enc.to(ctx.device, torch.float32).eval()
    task = build_task(args, get_dataset(args.dataset_name), enc,
                      c["finetune"]["steps_per_epoch"])
    weights.load_into(task.head, {k[5:]: v for k, v in w.items()
                                  if k.startswith("head.")})
    return task


def run(ctx: Ctx) -> Outcome:
    from audiossl_tpu_torch.downstream.finetune import FinetuneDraws

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    B = tr["batch"]
    if ctx.control:  # the products in TF32, the next precision down
        torch.backends.cuda.matmul.allow_tf32 = c["control"]["tf32"]
        torch.backends.cudnn.allow_tf32 = c["control"]["tf32"]
    w = weights.draw(clip_shapes(c, tr), ctx.seed, dev)
    task = build(ctx, w)
    state = task.init_state()
    state.step = c["finetune"]["start_step"]
    rows = task.rows(B, int(tr["crop_s"] * 16000))
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    rng = np.random.default_rng(ctx.seed + 2)
    pool = [draw_inputs(gen, c, tr, rows, dev, rng) for _ in range(tr["pool"])]
    feed = [(b, FinetuneDraws(lam=d["lam"], shift=d["shift"], dp=d["dp_u"]))
            for b, d in pool]

    names = list(state.params)
    p0 = {k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
    losses, g1 = [], None
    for i in range(tr["check_steps"]):
        state, m = task.train_step(state, *feed[i])
        losses.append(float(m["loss"]))
        if i == 0:  # the first momentum trace is the clipped gradient
            g1 = {k: float(state.mu[k].double().norm()) for k in names}
    params = state.params
    d_params = {k: float((params[k].detach().cpu() - p0[k]).double().norm())
                for k in names}
    del p0, params
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    loss_t = []

    def one(i):
        _, m = task.train_step(state, *feed[i % len(feed)])
        loss_t.append(m["loss"])

    out = Outcome(setup_s=setup_s, attempted=0, failed=0, e2e={},
                  memory_peak_bytes=0, numbers={})
    reset_peak(dev)
    n, secs = closed_loop(one, ctx.seconds, dev)
    out.attempted = n
    out.failed = int((~torch.isfinite(torch.stack(loss_t))).sum())
    if ctx.trace:
        out.unit_s = secs / n
        out.unit_flops = roofline.clip_finetune_step_flops(c, tr)
        out.peak_flops = roofline.PEAK_FLOPS[c["peak"]]
        k = [0]

        def traced():
            one(k[0])
            k[0] += 1

        out.traces = [trace.profile_units(traced, tr["profile_steps"])]
        out.bound_ctx = {"mel_band": roofline.mel_band(ref.mel_filterbank())}
    else:
        out.e2e["train_clips_per_s"] = n * B / secs
    out.memory_peak_bytes = peak_bytes(dev)
    inputs = pool[:tr["check_steps"]]
    del state, task, feed, pool, loss_t
    free(dev)
    out.numbers = reference_numbers(ctx, w, inputs, losses, g1, d_params)
    return out


def reference_numbers(ctx, w, inputs, losses, g1, d_params):
    c, tr = ctx.config, ctx.traffic
    f = c["finetune"]
    lr_base = f["learning_rate"] * f["global_batch"] / 256.0
    warm = f["warmup_epochs"] * f["steps_per_epoch"]
    total = f["max_epochs"] * f["steps_per_epoch"]
    cfg = {"crop_s": tr["crop_s"], "heads": c["num_heads"],
           "depth": c["num_layers"], "n_blocks": c["head_blocks"],
           "chunk_len": c["chunk_frames"],
           "drop_path_rate": f["drop_path_rate"],
           "grad_clip": f["grad_clip"], "momentum": f["momentum"],
           "layer_decay": f["layer_decay"]}
    with ref.strict_f32():
        P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        init = {k: v.detach().clone() for k, v in P.items()}
        mu = {k: torch.zeros_like(v) for k, v in P.items()}
        r_losses, r_g1 = [], None
        for i, (b, d) in enumerate(inputs):
            dev = ctx.device
            wav = torch.from_numpy(b["wav"]).to(dev)
            valid = torch.from_numpy(b["valid"]).to(dev)
            label = torch.from_numpy(b["label"]).to(dev)
            loss = ref.finetune_loss(P, wav, valid, label, d, cfg)
            names = list(P)
            grads = torch.autograd.grad(loss, [P[k] for k in names],
                                        allow_unused=True)
            grads = {k: torch.zeros_like(P[k]) if g is None else g
                     for k, g in zip(names, grads)}
            r_losses.append(float(loss.detach()))
            lr = ref.f32(ref.cosine(lr_base, 1e-6, total, warm,
                                    f["start_step"] + i))
            ref.sgd_clipped({k: v.data for k, v in P.items()}, grads, mu, lr,
                            cfg)
            if i == 0:
                r_g1 = compare.leaf_norms(mu)
        r_d = {k: float((P[k].detach() - init[k]).double().norm()) for k in P}
    moving = compare.moving_leaves(r_g1)
    return {"loss_gap": compare.loss_gap(losses, r_losses),
            "grad_gap": compare.worst_leaf_gap(g1, r_g1, moving)[0],
            "change_gap": compare.worst_leaf_gap(d_params, r_d, moving)[0]}
