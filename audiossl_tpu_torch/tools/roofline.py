"""Analytic roofline floors of the pretraining step on an NVIDIA H100
(port of ``scripts/roofline.py``, the same formulas): per-component
matmul FLOPs, the bf16 tensor-core time floor, the memory floors of the
optimizer + EMA pass and the mel front end, and the clips/s ceiling they
imply. Host arithmetic: nothing runs on the device.

Usage:
    python -m audiossl_tpu_torch.tools.roofline [--arch base] [--batch 96]
        [--anchor 10.0] [--views 2] [--peak-tflops 989]
        [--hbm-gbps 3350] [--int8-teacher] [--device cuda]

Peak defaults are the H100 SXM5 datasheet's dense figures, the ones the
port's kernel bounds use (PERF.md): 989 bf16 TFLOP/s, int8 at 2x that,
3.35 TB/s HBM3. N is the logical token count: the port pads no sequence
to a tile multiple.
"""
from __future__ import annotations

import argparse

from audiossl_tpu_torch.tools import add_device_flag, device_of

ARCHS = {
    "tiny": (192, 12, 3),
    "small": (384, 12, 6),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
}


def encoder_flops_per_view(B, N, C, depth):
    """Forward matmul FLOPs for one encoder pass over [B, N, C]."""
    per_layer = (
        2 * B * N * C * 3 * C        # qkv
        + 2 * B * N * N * C * 2      # scores + attn*V (all heads)
        + 2 * B * N * C * C          # proj
        + 2 * B * N * C * 4 * C * 2  # fc1 + fc2
    )
    return per_layer * depth


def head_flops_per_view(B, N, C, hidden=4096, out=256, predictor=True):
    f = 2 * B * N * (C * hidden + hidden * out)      # projector
    if predictor:
        f += 2 * B * N * (out * hidden + hidden * out)
    return f


def build_parser():
    ap = argparse.ArgumentParser("roofline", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--arch", default="base", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--anchor", type=float, default=10.0)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--peak-tflops", type=float, default=989.0,
                    help="dense bf16 peak (H100 SXM5 datasheet: 989)")
    ap.add_argument("--hbm-gbps", type=float, default=3350.0,
                    help="memory rate (H100 SXM5 datasheet: 3.35 TB/s)")
    ap.add_argument("--int8-teacher", action="store_true")
    ap.add_argument("--mel-passes", type=int, default=1,
                    help="mel computations per step (frame recipe: 1 - "
                         "both views augment the SAME crop's mel; clip "
                         "recipe: 2 crops -> 2)")
    ap.add_argument("--baseline", type=float, default=144.0,
                    help="reference clips/s per GPU: BASELINE.json's 144, the "
                         "PyTorch original on an 8-GPU node at batch 144 a "
                         "GPU (docs/PROFILE.md)")
    return add_device_flag(ap)


def floors(args) -> dict:
    """The floors in seconds and the ceiling in clips/s."""
    C, depth, _ = ARCHS[args.arch]
    B = args.batch
    # tokens: 64-mel full-height patches, 4 frames each, no padding
    frames = int(args.anchor * 16000) // 160 + 1
    N = frames // 4
    V = args.views

    enc = encoder_flops_per_view(B, N, C, depth)
    head = head_flops_per_view(B, N, C)
    t_head = head_flops_per_view(B, N, C, predictor=False)

    student = 3 * V * (enc + head)        # fwd + bwd(2x)
    teacher = V * (enc + t_head)          # fwd only (EMA, no grads)
    peak = args.peak_tflops * 1e12
    t_student = student / peak
    t_teacher = teacher / peak / (2.0 if args.int8_teacher else 1.0)

    # memory-bound tail (bytes): optimizer+EMA one fused pass ->
    # read p,g,mu,nu,t + write p,mu,nu,t (f32 masters, ~9 accesses).
    # per layer: qkv 3C^2 + proj C^2 + fc1 4C^2 + fc2 4C^2 = 12C^2
    # (+ ~10C biases/LN); plus pos/patch embeds and the BYOL heads.
    n_params = (depth * (12 * C * C + 10 * C)
                + (N + 1) * C + 256 * C            # pos + patch embed
                + C * 4096 + 4096 * 256            # projector
                + 256 * 4096 + 4096 * 256)         # predictor
    opt_bytes = n_params * 4 * 9
    t_opt = opt_bytes / (args.hbm_gbps * 1e9)
    # mel front-end: framed matmul [B*T,1024]x[1024,1026] per mel pass
    mel_flops = 2 * B * (frames * 4) * 1024 * 1026 / 4  # hop 160 ~ T/4 rows
    t_mel = args.mel_passes * (
        mel_flops / peak + (B * frames * 64 * 4 * 6) / (
            args.hbm_gbps * 1e9))
    t_total = t_student + t_teacher + t_opt + t_mel
    return {"arch": args.arch, "C": C, "depth": depth, "B": B, "N": N,
            "views": V, "student_s": t_student, "teacher_s": t_teacher,
            "opt_s": t_opt, "opt_gb": opt_bytes / 1e9, "mel_s": t_mel,
            "step_s": t_total, "clips_per_s": B / t_total,
            "baseline": args.baseline}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device_of(args)
    r = floors(args)
    print(f"arch={r['arch']} C={r['C']} depth={r['depth']} B={r['B']} "
          f"N={r['N']} logical tokens, views={r['views']}")
    print(f"student fwd+bwd matmul floor: {r['student_s'] * 1e3:8.2f} ms")
    print(f"teacher fwd matmul floor:     {r['teacher_s'] * 1e3:8.2f} ms"
          f"{'  (int8)' if args.int8_teacher else ''}")
    print(f"optimizer+EMA HBM floor:      {r['opt_s'] * 1e3:8.2f} ms "
          f"({r['opt_gb']:.2f} GB)")
    print(f"mel front-end floor:          {r['mel_s'] * 1e3:8.2f} ms")
    print(f"step floor:                   {r['step_s'] * 1e3:8.2f} ms")
    print(f"ceiling: {r['clips_per_s']:7.1f} clips/s/card = "
          f"{r['clips_per_s'] / args.baseline:.2f}x of {args.baseline:.0f}")
    return r


if __name__ == "__main__":
    main()
