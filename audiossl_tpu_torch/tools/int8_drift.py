"""Quantify the int8-teacher numerics cost (port of
``scripts/int8_drift.py``).

The opt-in ``teacher_quant="int8"`` recipe replaces the EMA teacher's
bf16 block kernels K2/K3 with the int8 ones K2q/K3q (per-output-channel
weight scales x per-row activation scales, ``ops/block_infer.py``). This
tool measures what that costs, end to end:

1. **Teacher-target drift**: the BYOL targets ``t_out`` of ATST-Frame
   (the projector output the student regresses onto), bf16 teacher
   against int8 teacher on the same parameters, inputs and drop-path
   draws: per-frame cosine (mean / p5 / min) and relative L2. At random
   init and after ``--steps`` pretraining steps.
2. **Probe delta**: mean-pooled teacher frames (bf16 against int8
   blocks, the same parameters) for K synthetic classes (harmonic
   stacks, class = f0 x AM-rate cell) through a closed-form ridge
   one-vs-all probe: both accuracies, and the cross condition (trained on
   bf16 features, tested on int8).

Both teachers run as on the card (bf16, the block kernels): the int8
recipe acts on that route only, so the CPU run (``--device cpu --tiny``)
takes the same route through the kernels' plain versions. Writes
``{out}/int8_drift.json`` and prints a markdown table.

Usage:
    python -m audiossl_tpu_torch.tools.int8_drift --steps 200
        --out docs/torch/artifacts
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from audiossl_tpu_torch.tools import add_device_flag, device_of


def synth_class_audio(rng, n, sr, seconds, k, n_classes, noise=0.05):
    """Class-k audio: harmonic stack at f0_k, amplitude-modulated at
    rate_k — separable but not trivially so under mel pooling.
    ``noise`` sets the additive-gaussian level; raise it (and
    n_classes) to make the probe task hard enough that a random-init
    encoder does NOT already saturate it (probe_gain.py needs
    headroom above the init accuracy)."""
    f0 = 80.0 * (2.0 ** (k / max(n_classes - 1, 1) * 3.0))  # 80..640 Hz
    am = 2.0 + 6.0 * ((k * 7) % n_classes) / max(n_classes - 1, 1)
    t = np.arange(int(seconds * sr)) / sr
    out = np.zeros((n, t.size), np.float32)
    for i in range(n):
        phase = rng.uniform(0, 2 * np.pi)
        sig = np.zeros_like(t)
        for h in range(1, 6):
            sig += rng.uniform(0.5, 1.0) / h * np.sin(
                2 * np.pi * f0 * h * (1 + rng.uniform(-.02, .02)) * t
                + phase * h)
        env = 0.6 + 0.4 * np.sin(2 * np.pi * am * t + rng.uniform(0, 6.28))
        out[i] = (sig * env + rng.randn(t.size) * noise).astype(np.float32)
        out[i] *= 0.1 / max(np.abs(out[i]).max(), 1e-6)
    return out


def ridge_probe(ftr, lab, fte, lte, lam=1e-2):
    """Closed-form one-vs-all ridge on f32 features -> accuracy."""
    x = np.asarray(ftr, np.float64)
    mu, sd = x.mean(0), x.std(0) + 1e-6
    x = (x - mu) / sd
    y = np.eye(int(lab.max()) + 1)[lab]
    w = np.linalg.solve(x.T @ x + lam * x.shape[0] * np.eye(x.shape[1]),
                        x.T @ y)
    xt = (np.asarray(fte, np.float64) - mu) / sd
    return float((np.argmax(xt @ w, 1) == lte).mean())


def pooled_frames(encoder, wav: np.ndarray, cfg, device, bs: int = 64):
    """Mean-pooled frames [n, D] (f32) of the encoder in inference mode
    over the mel of ``wav`` [n, L], ``bs`` clips a call. The last chunk is
    padded to ``bs`` rows, as JAX pads it for jit, so every call has one
    shape; the padding rows are dropped."""
    from audiossl_tpu_torch.ops.melspec import log_melspec

    was = encoder.training
    encoder.eval()
    out = []
    try:
        with torch.no_grad():
            for i in range(0, wav.shape[0], bs):
                chunk = wav[i:i + bs]
                if chunk.shape[0] < bs:
                    chunk = np.pad(chunk, ((0, bs - chunk.shape[0]), (0, 0)))
                w = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
                mel = log_melspec(w, None, cfg.mel)[:, :, :cfg.out_frames]
                ln = torch.full((w.shape[0],), mel.shape[2],
                                dtype=torch.long, device=device)
                frames, sel = encoder(mel, ln, apply_mask=False)
                selv = sel.float()[:, :, None]
                f = ((frames.float() * selv).sum(1)
                     / torch.clamp(selv.sum(1), min=1.0))
                out.append(f.cpu().numpy())
    finally:
        encoder.train(was)
    return np.concatenate(out)[:wav.shape[0]]


def build_parser():
    ap = argparse.ArgumentParser("int8_drift",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="pretrain steps before measuring (0 = init only)")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--per-class", type=int, default=48)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="docs/torch/artifacts")
    return add_device_flag(ap)


def make_methods(arch: str, device):
    """The bf16 and int8-teacher ``FrameMethod``s of JAX's ``mk`` on a
    TPU (6 s anchors, bf16, the kernels), both drawn from seed 0."""
    from audiossl_tpu_torch.methods.atstframe.method import (
        FrameMethod, FramePretrainConfig)
    from audiossl_tpu_torch.training.pretrain import OptimizerConfig

    def mk(q):
        return FramePretrainConfig(
            arch=arch, anchor_len=6.0,
            optimizer=OptimizerConfig(learning_rate=4e-4, warmup_steps=40,
                                      max_steps=4000, ema=0.99),
            dtype="bfloat16", fused_attention=True, teacher_quant=q)

    return FrameMethod(mk("none"), device), FrameMethod(mk("int8"), device)


def main(argv=None) -> dict:
    from audiossl_tpu_torch.datasets import (PackedAudioDataset,
                                             write_synthetic_pack)
    from audiossl_tpu_torch.datasets.pipeline import BatchLoader
    from audiossl_tpu_torch.methods.atstframe.method import frame_train_views

    args = build_parser().parse_args(argv)
    dev = device_of(args)
    arch = "tiny" if args.tiny else "base"
    m_bf, m_q8 = make_methods(arch, dev)
    state = m_bf.init_state(0)
    cfg = m_bf.cfg

    def sync_q8():
        """The int8 teacher takes the state's teacher as it stands (the
        weights stay f32 masters in both: codes are made per call)."""
        m_q8.teacher.load_state_dict(state.teacher.state_dict())

    def measure_drift(tag):
        """BYOL targets from the bf16 and the int8 teacher: the same
        parameters, inputs, augmentation and drop-path draws."""
        rng = np.random.RandomState(7)
        wav = np.concatenate(
            [synth_class_audio(rng, 2, 16000, cfg.anchor_len + 1.0, k,
                               args.classes)
             for k in range(args.batch // 2)], 0)[:args.batch]
        wav_t = torch.from_numpy(wav).to(dev)
        valid = torch.full((wav.shape[0],), wav.shape[1], dtype=torch.long,
                           device=dev)
        draws = m_bf.draw(torch.Generator(device=dev).manual_seed(3),
                          wav.shape[0])
        sync_q8()
        with torch.no_grad():
            mel2, frames2, mask2 = frame_train_views(wav_t, valid, cfg,
                                                     draws)
            outs = []
            for teacher in (state.teacher, m_q8.teacher):
                # a train-mode teacher (stochastic depth, BatchNorm batch
                # statistics) whose running statistics are left as they
                # were, as JAX drops the updated batch_stats
                saved = {k: v.clone() for k, v in teacher.named_buffers()}
                teacher.train()
                t_out, t_sel = teacher(mel2, frames2, mask_index=mask2,
                                       apply_mask=False,
                                       dps=draws.teacher_dp)
                for k, v in teacher.named_buffers():
                    v.copy_(saved[k])
                outs.append(t_out.float().cpu().numpy())
        a, b = outs
        sel = t_sel.cpu().numpy().astype(bool)
        av, bv = a[sel], b[sel]  # [n_frames, out_dim]
        cos = np.sum(av * bv, 1) / (
            np.linalg.norm(av, axis=1) * np.linalg.norm(bv, axis=1) + 1e-12)
        rel = np.linalg.norm(av - bv) / (np.linalg.norm(av) + 1e-12)
        r = {"cos_mean": float(cos.mean()), "cos_p5": float(
            np.percentile(cos, 5)), "cos_min": float(cos.min()),
            "rel_l2": float(rel)}
        print(f"[{tag}] target drift: cos mean {r['cos_mean']:.5f} "
              f"p5 {r['cos_p5']:.5f} min {r['cos_min']:.5f} "
              f"relL2 {r['rel_l2']:.4f}", flush=True)
        return r

    def measure_probe(tag):
        """Mean-pooled teacher frames -> ridge probe accuracy, bf16 and
        int8 blocks on the same teacher parameters."""
        rng = np.random.RandomState(11)
        n_tr, n_te = args.per_class, max(args.per_class // 3, 8)
        wavs, labs = [], []
        for k in range(args.classes):
            wavs.append(synth_class_audio(rng, n_tr + n_te, 16000,
                                          cfg.anchor_len, k, args.classes))
            labs.append(np.full(n_tr + n_te, k))
        wav = np.concatenate(wavs)
        lab = np.concatenate(labs)
        tr = np.concatenate([np.arange(i * (n_tr + n_te),
                                       i * (n_tr + n_te) + n_tr)
                             for i in range(args.classes)])
        te = np.setdiff1d(np.arange(lab.size), tr)
        sync_q8()
        f_bf = pooled_frames(state.teacher.encoder, wav, cfg, dev)
        f_q8 = pooled_frames(m_q8.teacher.encoder, wav, cfg, dev)
        acc_bf = ridge_probe(f_bf[tr], lab[tr], f_bf[te], lab[te])
        acc_q8 = ridge_probe(f_q8[tr], lab[tr], f_q8[te], lab[te])
        acc_x = ridge_probe(f_bf[tr], lab[tr], f_q8[te], lab[te])
        cos = np.sum(f_bf * f_q8, 1) / (
            np.linalg.norm(f_bf, axis=1) * np.linalg.norm(f_q8, axis=1)
            + 1e-12)
        r = {"probe_acc_bf16": acc_bf, "probe_acc_int8": acc_q8,
             "probe_acc_cross": acc_x, "probe_delta": acc_q8 - acc_bf,
             "embed_cos_mean": float(cos.mean()),
             "embed_cos_min": float(cos.min())}
        print(f"[{tag}] probe: bf16 {acc_bf:.4f} int8 {acc_q8:.4f} "
              f"cross {acc_x:.4f} embed-cos {cos.mean():.5f}", flush=True)
        return r

    results = {"arch": arch, "backend": dev.type,
               "at_init": {**measure_drift("init"), **measure_probe("init")}}

    if args.steps > 0:
        with tempfile.TemporaryDirectory(prefix="drift_data_") as data:
            write_synthetic_pack(data, "train", max(4 * args.batch, 128),
                                 min_s=6.0, max_s=8.0, kind="tones", seed=0)
            ds = PackedAudioDataset(data, "train")
            step_fn = m_bf.make_step()
            t0 = time.perf_counter()
            step = 0
            epoch = 0
            while step < args.steps:
                for b in BatchLoader(ds, args.batch,
                                     pad_samples=int(8.0 * 16000),
                                     shuffle=True, seed=0, epoch=epoch,
                                     num_threads=4, include_labels=False):
                    metrics = step_fn(state, b)
                    step += 1
                    if step % 50 == 0:
                        print(f"pretrain step {step}: loss "
                              f"{float(metrics['loss']):.4f}", flush=True)
                    if step >= args.steps:
                        break
                epoch += 1
        print(f"pretrained {step} steps in "
              f"{time.perf_counter() - t0:.0f}s", flush=True)
        results["after_steps"] = {
            "steps": step, **measure_drift(f"step{step}"),
            **measure_probe(f"step{step}")}

    print(json.dumps(results))
    tagv = results.get("after_steps", results["at_init"])
    print("\n| condition | target cos (mean/p5) | rel L2 | probe bf16 | "
          "probe int8 | cross |\n|---|---|---|---|---|---|")
    for name, rv in [("init", results["at_init"])] + (
            [(f"step{args.steps}", tagv)] if args.steps else []):
        print(f"| {name} | {rv['cos_mean']:.5f} / {rv['cos_p5']:.5f} | "
              f"{rv['rel_l2']:.4f} | {rv['probe_acc_bf16']:.4f} | "
              f"{rv['probe_acc_int8']:.4f} | {rv['probe_acc_cross']:.4f} |")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "int8_drift.json"), "w") as f:
            json.dump(results, f, indent=1)
        print(f"\nwrote {args.out}/int8_drift.json")
    return results


if __name__ == "__main__":
    main()
