"""Pretraining against downstream quality (port of
``scripts/probe_gain.py``).

Pretrains ATST-Frame small on synthetic-class audio and runs the
reference's frozen-encoder protocol at checkpoints along the way:
mean-pooled teacher frames -> closed-form one-vs-all ridge probe ->
held-out accuracy. Pass: the final accuracy well above step 0's.

``--corpus shape`` (default) encodes the class in augmentation-stable
structure (which harmonics sound, f0 and AM rate drawn per sample);
``--corpus f0am`` is ``int8_drift``'s corpus (class = f0 x AM cell),
whose accuracy falls as the augmentations train invariance to pitch and
rate. The pretraining corpus is written with the port's ``PackedWriter``.
On the card the recipe runs as JAX's does on a TPU (bf16, the kernels);
``--tiny`` is JAX's override (a 32-wide, 2-block f32 encoder on the
module route, branches 64 / 16, 2 s crops).

Writes ``{out}/probe_gain.json`` (and ``.png`` where matplotlib imports;
``_f0am`` and quant suffixes as JAX's).

Usage:
    python -m audiossl_tpu_torch.tools.probe_gain --steps 2000
        --probe-every 400
CPU smoke: --device cpu --tiny --steps 40 --probe-every 20.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from audiossl_tpu_torch.tools import add_device_flag, device_of
from audiossl_tpu_torch.tools.int8_drift import (pooled_frames, ridge_probe,
                                                 synth_class_audio)


def synth_shape_audio(rng, n, sr, seconds, k, n_classes, noise=0.05):
    """Class-k audio with augmentation-STABLE class structure: the
    class decides WHICH harmonics sound (bit b of k toggles harmonic
    b+2; fundamental and harmonic 8 are always-on anchors), while f0
    (80..640 Hz, log-uniform) and the AM rate are drawn per sample,
    uncorrelated with the class. Frequency rescaling (the RRC
    augmentation) translates the comb along the log-mel axis but
    preserves which teeth are present, so a representation that
    improves under the ATST augmentations can only do so by exposing
    the comb shape — the probe then measures representation quality,
    not invariance erosion (see module docstring)."""
    amp = np.array(
        [1.0] + [0.1 + 0.9 * ((k >> b) & 1) for b in range(6)] + [0.7],
        np.float32)
    t = np.arange(int(seconds * sr)) / sr
    out = np.zeros((n, t.size), np.float32)
    for i in range(n):
        f0 = 80.0 * (2.0 ** rng.uniform(0.0, 3.0))
        am = rng.uniform(2.0, 8.0)
        phase = rng.uniform(0, 2 * np.pi)
        sig = np.zeros_like(t)
        for h in range(1, 9):
            sig += (amp[h - 1] * rng.uniform(0.8, 1.2) / np.sqrt(h)
                    * np.sin(2 * np.pi * f0 * h
                             * (1 + rng.uniform(-.02, .02)) * t
                             + phase * h))
        env = 0.6 + 0.4 * np.sin(2 * np.pi * am * t
                                 + rng.uniform(0, 6.28))
        out[i] = (sig * env + rng.randn(t.size) * noise
                  ).astype(np.float32)
        out[i] *= 0.1 / max(np.abs(out[i]).max(), 1e-6)
    return out


def build_config(args):
    """JAX's ``FramePretrainConfig`` of this run, as its script builds it
    on a TPU (bf16, the kernels)."""
    from audiossl_tpu_torch.methods.atstframe.method import \
        FramePretrainConfig
    from audiossl_tpu_torch.training.pretrain import OptimizerConfig

    return FramePretrainConfig(
        arch="tiny" if args.tiny else "small",
        anchor_len=2.0 if args.tiny else 6.0,
        optimizer=OptimizerConfig(
            learning_rate=4e-4, warmup_steps=max(args.steps // 20, 10),
            max_steps=max(args.steps, 100), ema=0.99),
        dtype="bfloat16", fused_attention=True,
        teacher_quant=args.teacher_quant,
        student_quant=args.student_quant)


def build_method(args, device):
    """The method of ``build_config(args)`` on ``device``, with JAX's
    ``--tiny`` branches (``convergence_check.tiny_override``)."""
    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod
    from audiossl_tpu_torch.tools.convergence_check import tiny_override

    cfg = build_config(args)
    method = FrameMethod(cfg, device, seed=args.seed)
    if args.tiny:
        tiny_override(method, cfg.out_frames, use_cls=False, seed=args.seed)
    return method


def build_parser():
    ap = argparse.ArgumentParser("probe_gain",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--probe-every", type=int, default=400)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--classes", type=int, default=24)
    ap.add_argument("--per-class", type=int, default=60)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="docs/torch/convergence")
    ap.add_argument("--noise", type=float, default=1.2,
                    help="additive-noise level in synth_class_audio; the "
                         "default is chosen so a RANDOM-INIT encoder scores "
                         "well below 1.0 on the probe (headroom for the "
                         "gain measurement)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", default="shape",
                    choices=["shape", "f0am"],
                    help="'shape': class = harmonic comb, f0/AM "
                         "randomized (augmentation-stable class signal "
                         "— the representation-quality measurement); "
                         "'f0am': class = f0 x AM cell (augmentation-"
                         "UNSTABLE; accuracy falls as invariance is "
                         "learned — kept as the invariance demo)")
    ap.add_argument("--teacher-quant", default="none",
                    choices=["none", "int8"],
                    help="A/B the quantized-teacher recipe variant")
    ap.add_argument("--student-quant", default="none",
                    choices=["none", "int8", "int8dx"],
                    help="A/B the quantized-student recipe variant")
    return add_device_flag(ap)


def main(argv=None) -> dict:
    from audiossl_tpu_torch.datasets.packed import (PackedAudioDataset,
                                                    PackedWriter)
    from audiossl_tpu_torch.datasets.pipeline import BatchLoader

    args = build_parser().parse_args(argv)
    dev = device_of(args)
    method = build_method(args, dev)
    cfg = method.cfg
    arch = cfg.arch

    # ---- corpora: pretrain pack + probe train/test sets, same classes
    rng = np.random.RandomState(args.seed)
    gen = synth_shape_audio if args.corpus == "shape" else synth_class_audio
    sec = cfg.anchor_len + 1.0
    n_pretrain = max(8 * args.batch, 384)
    tmp = tempfile.TemporaryDirectory(prefix="probe_gain_data_")
    with PackedWriter(os.path.join(tmp.name, "train.ards")) as writer:
        for i in range(n_pretrain):
            k = i % args.classes
            w = gen(rng, 1, cfg.sr, sec, k, args.classes, args.noise)[0]
            writer.add(np.clip(w * 32767, -32767, 32767).astype(np.int16),
                       int(k), cfg.sr)
    dataset = PackedAudioDataset(tmp.name, "train")

    n_tr, n_te = args.per_class, max(args.per_class // 3, 8)
    wavs, labs = [], []
    for k in range(args.classes):
        wavs.append(gen(rng, n_tr + n_te, cfg.sr, cfg.anchor_len, k,
                        args.classes, args.noise))
        labs.append(np.full(n_tr + n_te, k))
    probe_wav = np.concatenate(wavs)
    probe_lab = np.concatenate(labs)
    tr = np.concatenate([np.arange(i * (n_tr + n_te),
                                   i * (n_tr + n_te) + n_tr)
                         for i in range(args.classes)])
    te = np.setdiff1d(np.arange(probe_lab.size), tr)

    def probe_acc(state):
        """Frozen-teacher mean-pooled frame embeddings -> ridge probe
        (the reference freeze protocol, one linear layer, no aug)."""
        f = pooled_frames(state.teacher.encoder, probe_wav, cfg, dev)
        return ridge_probe(f[tr], probe_lab[tr], f[te], probe_lab[te])

    step_fn = method.make_step()
    state = method.init_state(args.seed)
    curve = [{"step": 0, "acc": probe_acc(state), "loss": None}]
    print(f"step 0: probe acc {curve[0]['acc']:.4f}", flush=True)

    pad = int(sec * cfg.sr)
    step = 0
    epoch = 0
    t0 = time.perf_counter()
    try:
        while step < args.steps:
            loader = BatchLoader(dataset, args.batch, pad_samples=pad,
                                 shuffle=True, seed=args.seed, epoch=epoch,
                                 num_threads=4, include_labels=False)
            for b in loader:
                metrics = step_fn(state, b)
                step += 1
                if step % args.probe_every == 0 or step == args.steps:
                    loss = float(metrics["loss"])
                    acc = probe_acc(state)
                    curve.append({"step": step, "acc": acc, "loss": loss})
                    print(f"step {step}: loss {loss:.4f} probe acc "
                          f"{acc:.4f}", flush=True)
                if step >= args.steps:
                    break
            epoch += 1
    finally:
        tmp.cleanup()

    summary = {
        "arch": arch, "steps": args.steps, "batch": args.batch,
        "classes": args.classes, "noise": args.noise,
        "corpus": args.corpus,
        "teacher_quant": args.teacher_quant,
        "student_quant": args.student_quant,
        "acc_init": curve[0]["acc"], "acc_final": curve[-1]["acc"],
        "acc_gain": curve[-1]["acc"] - curve[0]["acc"],
        "wall_s": round(time.perf_counter() - t0, 1),
        "curve": curve,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "curve"}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        suffix = "" if args.corpus == "shape" else f"_{args.corpus}"
        if args.teacher_quant != "none":
            suffix += f"_tea{args.teacher_quant}"
        if args.student_quant != "none":
            suffix += f"_stu{args.student_quant}"
        base = os.path.join(args.out, "probe_gain" + suffix)
        with open(base + ".json", "w") as f:
            json.dump(summary, f, indent=1)
        try:
            import matplotlib
        except ImportError:
            print(f"wrote {base}.json (matplotlib unavailable)")
        else:
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(7, 4))
            ax.plot([c["step"] for c in curve], [c["acc"] for c in curve],
                    marker="o")
            ax.set_xlabel("pretrain step")
            ax.set_ylabel("frozen-probe accuracy (held out)")
            ax.set_title(f"ATST-Frame {arch}: linear-probe accuracy vs "
                         "pretraining")
            ax.grid(alpha=0.3)
            fig.tight_layout()
            fig.savefig(base + ".png", dpi=120)
            print(f"wrote {base}.json / .png")
    return summary


if __name__ == "__main__":
    main()
