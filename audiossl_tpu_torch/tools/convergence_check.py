"""Convergence evidence for the pretraining recipes (port of
``scripts/convergence_check.py``).

Runs ATST-Frame and/or ATST-Clip small pretraining on structured
synthetic audio (AM harmonic stacks in a ``.ards`` pack) and records the
loss and the teacher and student feature standard deviations (the
reference's collapse telemetry, ``std_frm_tea``/``_stu`` or
``std_cls_t``/``_s``). Pass: the tail-mean loss below the head-mean loss,
and a teacher std that never collapses towards 0.

``--tiny`` is JAX's override, not the port's tiny arch: a 32-wide,
2-block, 2-head encoder (f32, the module route) with branches of hidden
width 64 and output 16, on 2 s crops in f32.

Writes ``{out}/{method}_curve.json`` (and ``.png`` where matplotlib
imports).

Usage:
    python -m audiossl_tpu_torch.tools.convergence_check --method frame
        --steps 400
    python -m audiossl_tpu_torch.tools.convergence_check --method clip
        --steps 400
CPU smoke: add --device cpu --tiny --steps 60.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from audiossl_tpu_torch.tools import add_device_flag, device_of

STD_KEYS = {"frame": ("std_frm_tea", "std_frm_stu"),
            "clip": ("std_cls_t", "std_cls_s")}


def tiny_override(method, spec_w: int, use_cls: bool, seed: int = 0):
    """JAX's ``--tiny`` branches in place of ``method``'s: one
    ``AudioTransformer(embed_dim=32, depth=2, num_heads=2)`` definition
    (f32, no kernel flag: the module route, as flax's defaults build it)
    for the student and the teacher, a projector and predictor of hidden
    width 64 and output 16; parameters drawn from ``seed``."""
    from audiossl_tpu_torch.models.atst import AudioTransformer
    from audiossl_tpu_torch.training.pretrain import Branch

    gen = torch.Generator().manual_seed(seed)

    def enc():
        return AudioTransformer(embed_dim=32, depth=2, num_heads=2,
                                spec_h=64, spec_w=spec_w, use_cls=use_cls,
                                device="cpu", generator=gen)

    method.student = Branch(enc(), projector="mlp", predictor=True,
                            hidden_dim=64, out_dim=16)
    method.teacher = Branch(enc(), projector="mlp", predictor=False,
                            hidden_dim=64, out_dim=16)
    with torch.no_grad():
        method.student.head.reset_parameters(gen)
    method.student.to(method.device)
    method.teacher.to(method.device).requires_grad_(False)
    method.depth = 2
    return method


def build_config(method_name: str, tiny: bool, teacher_quant: str = "none",
                 student_quant: str = "none"):
    """The configuration of JAX's ``build``: ATST-Frame or ATST-Clip
    small, 6 s crops in bf16 (``tiny``: 2 s in f32)."""
    from audiossl_tpu_torch.training.pretrain import OptimizerConfig

    opt = OptimizerConfig(learning_rate=4e-4, warmup_steps=40,
                          max_steps=4000, ema=0.99)
    dtype = "float32" if tiny else "bfloat16"
    if method_name == "frame":
        from audiossl_tpu_torch.methods.atstframe.method import \
            FramePretrainConfig

        return FramePretrainConfig(
            arch="small", anchor_len=2.0 if tiny else 6.0, optimizer=opt,
            dtype=dtype, teacher_quant=teacher_quant,
            student_quant=student_quant)
    from audiossl_tpu_torch.methods.atst.method import ClipPretrainConfig

    ln = (2.0, 2.0) if tiny else (6.0, 6.0)
    return ClipPretrainConfig(
        arch="small", anchor_len=ln, positive_len=ln, optimizer=opt,
        dtype=dtype, teacher_quant=teacher_quant,
        student_quant=student_quant)


def build(method_name: str, tiny: bool, teacher_quant: str = "none",
          student_quant: str = "none", device="cuda"):
    """JAX's ``build``: (method, cfg, teacher std key), the method of
    :func:`build_config` on ``device`` (``tiny``: with the branches of
    :func:`tiny_override`)."""
    from audiossl_tpu_torch.methods.atst.method import ClipMethod
    from audiossl_tpu_torch.methods.atstframe.method import FrameMethod

    cfg = build_config(method_name, tiny, teacher_quant, student_quant)
    if method_name == "frame":
        cls, spec_w = FrameMethod, cfg.out_frames
    else:
        cls, spec_w = ClipMethod, int(cfg.anchor_len[0] * 16000) // 160 + 1
    key = STD_KEYS[method_name][0]
    if not tiny:
        return cls(cfg, device), cfg, key
    # the small branches are replaced: build the method at the tiny arch
    # (nothing reads cfg.arch after construction) and keep cfg as JAX's
    method = cls(dataclasses.replace(cfg, arch="tiny"), device)
    method.cfg = cfg
    return tiny_override(method, spec_w, method_name == "clip"), cfg, key


def run(method_name: str, steps: int, batch: int, tiny: bool,
        out_dir: str | None, seed: int = 0, teacher_quant: str = "none",
        student_quant: str = "none", device="cuda"):
    """JAX's ``run``: (summary, history)."""
    from audiossl_tpu_torch.datasets import (PackedAudioDataset,
                                             write_synthetic_pack)
    from audiossl_tpu_torch.datasets.pipeline import BatchLoader

    method, cfg, std_key = build(method_name, tiny, teacher_quant,
                                 student_quant, device)
    stu_key = STD_KEYS[method_name][1]
    n_clips = max(4 * batch, 256 if not tiny else 64)
    clip_s = cfg.anchor_len if method_name == "frame" else cfg.anchor_len[0]
    step_fn = method.make_step()
    state = method.init_state(seed)
    pad = int((clip_s + 2.0) * 16000)

    hist = {"loss": [], "std_tea": [], "std_stu": []}
    step = 0
    t0 = time.perf_counter()
    epoch = 0
    with tempfile.TemporaryDirectory(prefix="convergence_data_") as data:
        write_synthetic_pack(data, "train", n_clips, min_s=clip_s,
                             max_s=clip_s + 2.0, kind="tones", seed=seed)
        dataset = PackedAudioDataset(data, "train")
        while step < steps:
            loader = BatchLoader(dataset, batch, pad_samples=pad,
                                 shuffle=True, seed=seed, epoch=epoch,
                                 num_threads=4, include_labels=False)
            for b in loader:
                metrics = step_fn(state, b)
                hist["loss"].append(float(metrics["loss"]))
                hist["std_tea"].append(float(metrics[std_key]))
                hist["std_stu"].append(float(metrics[stu_key]))
                step += 1
                if step % 50 == 0:
                    print(f"step {step}: loss {hist['loss'][-1]:.4f} "
                          f"std_tea {hist['std_tea'][-1]:.4f}", flush=True)
                if step >= steps:
                    break
            epoch += 1

    k = max(len(hist["loss"]) // 10, 1)
    head = float(np.mean(hist["loss"][:k]))
    tail = float(np.mean(hist["loss"][-k:]))
    std_floor = float(np.min(hist["std_tea"][k:] or hist["std_tea"]))
    summary = {
        "method": method_name, "steps": steps, "batch": batch,
        "tiny": tiny, "teacher_quant": teacher_quant,
        "student_quant": student_quant,
        "head_loss": head, "tail_loss": tail,
        "loss_drop": head - tail, "min_teacher_std_after_warmup": std_floor,
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    print(json.dumps(summary))

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if teacher_quant == "none" else f"_{teacher_quant}"
        if student_quant != "none":
            suffix += f"_stu{student_quant}"
        base = os.path.join(out_dir, f"{method_name}_curve{suffix}")
        with open(base + ".json", "w") as f:
            json.dump({**summary, **hist}, f)
        try:
            import matplotlib
        except ImportError:
            print(f"wrote {base}.json (matplotlib unavailable: no plot)")
        else:
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(7, 6), sharex=True)
            ax1.plot(hist["loss"], lw=0.8)
            ax1.set_ylabel("BYOL loss")
            quant_tag = ("" if teacher_quant == "none"
                         else f", {teacher_quant} teacher")
            if student_quant != "none":
                quant_tag += f", {student_quant} student"
            ax1.set_title(f"ATST-{method_name} pretrain convergence "
                          f"({steps} steps, batch {batch}{quant_tag})")
            ax2.plot(hist["std_tea"], lw=0.8, label="teacher std")
            ax2.plot(hist["std_stu"], lw=0.8, label="student std")
            ax2.axhline(0.0, color="k", lw=0.5)
            ax2.set_ylabel("feature std (collapse telemetry)")
            ax2.set_xlabel("step")
            ax2.legend()
            fig.tight_layout()
            fig.savefig(base + ".png", dpi=110)
            print(f"curve written to {base}.png")
    return summary, hist


def build_parser():
    ap = argparse.ArgumentParser("convergence_check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", choices=["frame", "clip", "both"],
                    default="both")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--tiny", action="store_true",
                    help="2-block/32-dim encoder for CPU smoke runs")
    ap.add_argument("--out", default="docs/torch/convergence")
    ap.add_argument("--teacher-quant", default="none",
                    choices=["none", "int8"],
                    help="A/B the int8 teacher recipe variant; output "
                         "files gain an _int8 suffix")
    ap.add_argument("--student-quant", default="none",
                    choices=["none", "int8", "int8dx"],
                    help="A/B the int8-student-forward recipe variant "
                         "(QAT straight-through backward)")
    return add_device_flag(ap)


def main(argv=None) -> dict:
    """Runs each method; returns {method: (summary, history)}."""
    args = build_parser().parse_args(argv)
    dev = device_of(args)
    methods = ["frame", "clip"] if args.method == "both" else [args.method]
    out = {}
    for m in methods:
        summary, hist = run(m, args.steps, args.batch, args.tiny, args.out,
                            teacher_quant=args.teacher_quant,
                            student_quant=args.student_quant, device=dev)
        if summary["tail_loss"] >= summary["head_loss"]:
            raise RuntimeError(f"{m}: loss did not decrease")
        out[m] = (summary, hist)
    return out


if __name__ == "__main__":
    main()
