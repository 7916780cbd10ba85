"""The yardstick's arithmetic: the card's peaks, a model's FLOPs from its
shapes, and the least time each kernel of the measured program could take.

Peaks are NVIDIA's data sheet for the H100 SXM (dense): 989 TFLOP/s bf16,
1,979 int8, 67 float32 outside the tensor cores, 3.35 TB/s of HBM3. A
kernel's bound is the larger of its operations over the peak of their type
and its bytes over the memory rate, each input byte read once and each
output byte written once (scratch buffers that a kernel writes and reads
back are not counted). FLOPs count 2 a multiply-add. Attention counts every
key of a sequence: the cells' clips fill their windows, so every key is
valid.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
BF16, F32 = 2, 4


# ------------------------------------------------------------- model FLOPs
def encoder_flops(seqs: int, tokens: int, width: int, mlp: int, depth: int,
                  patch: int) -> float:
    """Forward FLOPs of a ViT encoder over ``seqs`` sequences of ``tokens``:
    the patch projection, and per block qkv, the scores and their product
    with the values, the output projection and the two MLP products."""
    per_block = (2 * tokens * width * 3 * width + 2 * 2 * tokens * tokens * width
                 + 2 * tokens * width * width + 2 * 2 * tokens * width * mlp)
    return float(seqs) * (depth * per_block + 2 * tokens * patch * width)


def mlp_head_flops(rows: int, d_in: int, hidden: int, out: int) -> float:
    return 2.0 * rows * (d_in * hidden + hidden * out)


def frame_pretrain_step_flops(cfg: dict, batch: int) -> float:
    """One ATST-Frame step: both views through the student (encoder,
    projector, predictor; forward and a backward of twice the forward) and
    through the teacher (encoder and projector, forward only)."""
    seqs = 2 * batch
    tokens = (cfg["n_mels"] // cfg["patch_freq"]) * (
        cfg["crop_frames"] // cfg["patch_time"])
    w, m, d = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_layers"]
    p = cfg["patch_freq"] * cfg["patch_time"]
    enc = encoder_flops(seqs, tokens, w, m, d, p)
    proj = mlp_head_flops(seqs * tokens, w, cfg["head_hidden"], cfg["head_out"])
    pred = mlp_head_flops(seqs * tokens, cfg["head_out"], cfg["head_hidden"],
                          cfg["head_out"])
    return 3.0 * (enc + proj + pred) + (enc + proj)


def clip_finetune_step_flops(cfg: dict, traffic: dict) -> float:
    """One finetuning step: the chunked clip encoder (CLS plus each chunk's
    patches) and the linear head, forward and a backward of twice it."""
    frames = traffic["crop_s"] * 16000 // 160 + 1
    chunk = cfg["chunk_frames"]
    nc = int(frames) // chunk + 1
    tokens = (cfg["n_mels"] // cfg["patch_freq"]) * (chunk // cfg["patch_time"]) + 1
    w, m, d = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_layers"]
    B = traffic["batch"]
    enc = encoder_flops(B * nc, tokens, w, m, d,
                        cfg["patch_freq"] * cfg["patch_time"])
    head = 2.0 * B * 2 * cfg["head_blocks"] * w * traffic["num_labels"]
    return 3.0 * (enc + head)


def frame_embed_call_flops(cfg: dict, traffic: dict) -> float:
    """One scene-embedding call: the frame encoder's forward over each clip's
    chunks of ``serve_chunk_frames``."""
    frames = int(traffic["clip_s"] * 16000) // 160 + 1
    chunk = cfg["serve_chunk_frames"]
    nc = max((frames + chunk - 1) // chunk, 1)
    tokens = (cfg["n_mels"] // cfg["patch_freq"]) * (chunk // cfg["patch_time"])
    return encoder_flops(traffic["batch"] * nc, tokens, cfg["hidden_size"],
                         cfg["intermediate_size"], cfg["num_layers"],
                         cfg["patch_freq"] * cfg["patch_time"])


# ------------------------------------------------------------ kernel bounds
def bound_s(nbytes: float, **flops) -> float:
    t_ops = sum(n / PEAK_FLOPS[k] for k, n in flops.items())
    return max(t_ops, nbytes / PEAK_BYTES)


def mel_band(fb: np.ndarray) -> Tuple[int, int, int]:
    """(first bin, last bin, non-zero weights) of a mel filterbank."""
    nz = fb != 0
    bins = np.flatnonzero(nz.any(1))
    return int(bins[0]), int(bins[-1]), int(nz.sum())


def kernel_bound_s(name: str, ints: Tuple[int, ...], ctx: dict
                   ) -> Optional[float]:
    """The least time of one launch of the program's C entry point ``name``
    with integer arguments ``ints`` (its shapes, in the entry point's
    order); None for an entry point this table does not know. ``ctx``
    gives what the integers do not: the mel filterbank's band
    (``mel_band``) and the optimizer's leaf sizes (``adamw_elements``,
    ``adamw_teacher_elements``)."""
    if name == "mel_db":  # |STFT|^2 -> mel -> dB over the filterbank's band
        B, Fq, T, n_mels = ints[:4]
        lo, hi, terms = ctx["mel_band"]
        nbytes = F32 * (2 * (hi - lo + 1) * B * T + n_mels * B * T)
        return bound_s(nbytes, f32=5.0 * terms * B * T)
    if name in ("attn_block", "attn_train_fwd", "attn_train_bwd"):
        B, N, C, H = ints[:4]
        M = B * N
        pairs = B * N * N
        w = BF16 * 4 * C * C + F32 * 6 * C
        if name == "attn_block":
            return bound_s(BF16 * 2 * M * C + F32 * 2 * M + w,
                           bf16=8.0 * M * C * C + 4.0 * C * pairs)
        if name == "attn_train_fwd":  # out, and qkv, o, row stats saved
            return bound_s(BF16 * (2 * M * C + 4 * M * C) + F32 * (2 * M + M * H)
                           + w, bf16=8.0 * M * C * C + 4.0 * C * pairs)
        # x, dy, qkv, o, row stats in; dx and every f32 gradient out
        return bound_s(BF16 * (M * C * 6 + M * C) + F32 * (M * H + M)
                       + BF16 * 4 * C * C + F32 * (4 * C * C + 6 * C),
                       bf16=16.0 * M * C * C + 10.0 * C * pairs)
    if name in ("mlp_block", "mlp_train_fwd", "mlp_train_bwd"):
        B, N, C, Hd = ints[:4]
        M = B * N
        w = BF16 * 2 * C * Hd + F32 * (3 * C + Hd)
        mm = 4.0 * M * C * Hd
        if name == "mlp_block":
            return bound_s(BF16 * 2 * M * C + w, bf16=mm)
        if name == "mlp_train_fwd":  # out and the pre-activation saved
            return bound_s(BF16 * (2 * M * C + M * Hd) + w, bf16=mm)
        return bound_s(BF16 * (3 * M * C + M * Hd) + w
                       + F32 * (2 * C * Hd + 3 * C + Hd), bf16=2 * mm)
    if name == "ln_pg_bwd":  # x, dy, scale in; dx, d scale and bias out
        _, dtype, R, C = ints[:4]
        es = F32 if dtype == 0 else BF16
        return bound_s(es * 3 * R * C + F32 * 3 * C, f32=10.0 * R * C)
    if name == "adamw_ema":  # p, g, mu, nu in and out; the teacher's too
        n, nt = ctx["adamw_elements"], ctx["adamw_teacher_elements"]
        return bound_s(F32 * (7 * n + 2 * nt), f32=20.0 * n)
    return None


def launches_bound_s(launches, ctx: dict) -> Optional[float]:
    """Sum of the bounds of recorded launches; None if one is unknown."""
    total = 0.0
    for name, ints in launches:
        b = kernel_bound_s(name, ints, ctx)
        if b is None:
            return None
        total += b
    return total
