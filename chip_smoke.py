#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port's serving path (ATST-Frame base).

Run from the repository root on a machine with one CUDA GPU (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the hand-written CUDA
   kernels from ``audiossl_tpu_torch/csrc`` and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   serving shapes (8 clips of 10 s, 250 tokens, width 768), with its
   error and both times from CUDA events;
3. writes a seeded random ATST-Frame base encoder as a reference-layout
   ``.ckpt``, loads it with ``load_model(fused=True)`` and
   ``load_model(fused=False)``, and drives ``get_scene_embedding`` (8 x
   10 s, and 1 x 160,320 samples: two chunks, the second with no valid
   token) and ``get_timestamp_embedding`` through the kernels, checking
   shapes, finiteness, launch counts and agreement with the plain f32
   path on the card, and the plain f32 path on the card against the CPU;
4. times scene embedding (clips/s, B=8) on both paths.

Any failed check raises and exits non-zero. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
The last two lines are a JSON summary of the kernels and the result line
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
B, SAMPLES = 8, 160000  # 8 clips of 10 s at 16 kHz
LONG = 160320  # 1003 frames: a second chunk with 2 frames, no valid token
N, C, H, HID = 250, 768, 12, 3072  # ATST-Frame base tokens per 10 s chunk
K1_ATOL_DB = 1e-3  # f32 kernel vs f32 plain: summation order only
BLOCK_REL_L2 = 1e-2  # bf16 kernel vs bf16 plain: same rounding points,
# f32 sums in another order can move an element by one bf16 step
COS_MIN = 0.995  # fused bf16 vs plain f32: bf16 weights and residual
# stream over 12 blocks
CPU_ATOL = 1e-3  # plain f32 on the card vs the CPU: f32 summation order


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"ok: {what}")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def row_cos(a, b):
    a = a.reshape(-1, a.shape[-1]).double()
    b = b.reshape(-1, b.shape[-1]).double()
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def kernel_checks(dev):
    """K1, K2, K3 against their plain versions at the serving shapes."""
    from audiossl_tpu_torch.ops import block_infer as bi
    from audiossl_tpu_torch.ops.mel_db import stft_to_mel_db, stft_to_mel_db_ref
    from audiossl_tpu_torch.ops.melspec import MelConfig, mel_filterbank, stft_conv

    rng = np.random.RandomState(SEED)
    res = {}
    cfg = MelConfig()
    wav = torch.from_numpy((rng.randn(B, SAMPLES) * 0.1).astype(np.float32))
    stft = stft_conv(wav.to(dev), cfg)
    fb = mel_filterbank(cfg, dev)
    got = stft_to_mel_db(stft, fb, cfg.amin)
    want = stft_to_mel_db_ref(stft, fb, cfg.amin)
    err = float((got - want).abs().max())
    print(f"K1 mel_db {tuple(stft.shape)} -> {tuple(got.shape)}: "
          f"max_abs_err {err} dB, rel_l2 {rel_l2(got, want)}")
    check(err <= K1_ATOL_DB, f"K1 max abs error {err} <= {K1_ATOL_DB} dB")
    res["mel_db"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: stft_to_mel_db(stft, fb, cfg.amin)),
        plain_ms=cuda_ms(lambda: stft_to_mel_db_ref(stft, fb, cfg.amin)))

    def t(*shape, s=1.0, off=0.0, dtype=torch.float32):
        a = (rng.randn(*shape) * s + off).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    bf = torch.bfloat16
    x = t(B, N, C, dtype=bf)
    lengths = torch.tensor([250, 200, 137, 64, 1, 0, 250, 99], device=dev)
    valid = (torch.arange(N, device=dev)[None] < lengths[:, None]).float()
    dp = torch.tensor([1, 0, 1 / 0.9, 1, 1, 1 / 0.9, 0, 1], device=dev,
                      dtype=torch.float32)
    attn_args = (x, valid, t(C, s=0.1, off=1.0), t(C, s=0.1),
                 t(3 * C, C, s=0.05, dtype=bf), t(3 * C, s=0.02),
                 t(C, C, s=0.05, dtype=bf), t(C, s=0.02), H)
    mlp_args = (x, t(C, s=0.1, off=1.0), t(C, s=0.1),
                t(HID, C, s=0.05, dtype=bf), t(HID, s=0.02),
                t(C, HID, s=0.05, dtype=bf), t(C, s=0.02))
    for name, fn, ref, args in (
            ("attn_block", bi.attn_block_infer, bi.attn_block_infer_ref,
             attn_args),
            ("mlp_block", bi.mlp_block_infer, bi.mlp_block_infer_ref,
             mlp_args)):
        got = fn(*args, dp=dp)
        want = ref(*args, dp=dp)
        r = rel_l2(got, want)
        rb = rel_l2(got.float() - x.float(), want.float() - x.float())
        err = float((got.float() - want.float()).abs().max())
        print(f"{name} {tuple(x.shape)} bf16: rel_l2 {r}, residual-branch "
              f"rel_l2 {rb}, max_abs_err {err}, "
              f"equal {float((got == want).float().mean())}")
        check(bool(torch.isfinite(got.float()).all()), f"{name} finite")
        check(r <= BLOCK_REL_L2, f"{name} rel L2 {r} <= {BLOCK_REL_L2}")
        check(rb <= BLOCK_REL_L2,
              f"{name} residual-branch rel L2 {rb} <= {BLOCK_REL_L2}")
        res[name] = dict(max_abs_err=err,
                         ms=cuda_ms(lambda: fn(*args, dp=dp)),
                         plain_ms=cuda_ms(lambda: ref(*args, dp=dp)))
    return res


def main_path(dev, workdir):
    """The public embedding API at ATST-Frame base width, through the
    kernels; returns the launch counts of that run."""
    from audiossl_tpu_torch.embedding import (get_scene_embedding,
                                              get_timestamp_embedding,
                                              load_model)
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.models.atst import frame_ast_base

    enc = frame_ast_base(spec_w=1001, generator=torch.Generator().manual_seed(SEED))
    path = os.path.join(workdir, "atstframe_base.ckpt")
    torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                               for k, v in enc.state_dict().items()},
                "hyper_parameters": {"arch": "base"}}, path)
    fused = load_model(path, fused=True, device=dev)
    plain = load_model(path, fused=False, device=dev)
    rng = np.random.RandomState(SEED + 1)
    wav8 = (rng.randn(B, SAMPLES) * 0.1).astype(np.float32)
    wav1 = (rng.randn(1, LONG) * 0.1).astype(np.float32)

    torch.cuda.synchronize()
    kb.reset_launches()
    scene8 = get_scene_embedding(wav8, fused)
    scene1 = get_scene_embedding(wav1, fused)
    ts1, tms = get_timestamp_embedding(wav1, fused)
    torch.cuda.synchronize()
    launches = dict(kb.LAUNCHES)
    print(f"main path launches (3 forwards): {launches}")
    check(launches["mel_db"] >= 3, "mel kernel launched in every forward")
    check(launches["attn_block"] == 3 * 12 and launches["mlp_block"] == 3 * 12,
          "12 attention and 12 MLP block launches per forward")

    check(tuple(scene8.shape) == (B, 12 * C), f"scene shape {tuple(scene8.shape)}")
    check(tuple(scene1.shape) == (1, 12 * C), f"long-clip scene shape {tuple(scene1.shape)}")
    check(tuple(ts1.shape) == (1, 500, 12 * C), f"timestamp shape {tuple(ts1.shape)}")
    check(tuple(tms.shape) == (1, 500) and float(tms[0, 1] - tms[0, 0]) == 40.0,
          "timestamps every 40 ms")
    for name, v in (("scene", scene8), ("long scene", scene1), ("timestamp", ts1)):
        check(bool(torch.isfinite(v).all()), f"{name} embedding finite")

    p8 = get_scene_embedding(wav8, plain)
    p1 = get_scene_embedding(wav1, plain)
    pts, _ = get_timestamp_embedding(wav1, plain)
    cs8, cs1, cts = row_cos(scene8, p8), row_cos(scene1, p1), row_cos(ts1, pts)
    # Timestamp rows 250..499 come from the second chunk, which holds no
    # valid token (2 frames of audio, no whole patch): padding, not audio.
    # There the block kernels attend uniformly over all keys (the TPU
    # kernel's rule, pallas_block.py:319-325) while the module path takes
    # the softmax over keys that all carry the -10000 mask; the JAX
    # package's two paths differ there in the same way. Those rows are
    # reported and held to finiteness only.
    print(f"cosine fused vs plain f32: scene min {float(cs8.min())}, long "
          f"scene {float(cs1.min())}, timestamp rows with audio min "
          f"{float(cts[:250].min())}, padding rows of the chunk with no "
          f"valid token min {float(cts[250:].min())}")
    for name, cs in (("scene", cs8), ("long scene", cs1),
                     ("timestamp (rows with audio)", cts[:250])):
        check(float(cs.min()) >= COS_MIN,
              f"{name} per-row cosine {float(cs.min())} >= {COS_MIN}")

    cpu = load_model(path, fused=False, device="cpu")
    c1 = get_scene_embedding(wav8[:1], cpu)
    d = float((p8[:1].cpu() - c1).abs().max())
    print(f"plain f32 card vs CPU, 1 clip: max abs diff {d}, cosine "
          f"{float(row_cos(p8[:1].cpu(), c1).min())}")
    check(d <= CPU_ATOL, f"plain path on the card matches the CPU within {CPU_ATOL}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB")

    # scene-embedding throughput, in turns: plain, fused, fused, plain
    rates = {"plain_f32": [], "fused_bf16": []}
    for label in ("plain_f32", "fused_bf16", "fused_bf16", "plain_f32"):
        model = plain if label == "plain_f32" else fused
        for _ in range(2):
            get_scene_embedding(wav8, model)
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            get_scene_embedding(wav8, model)
        torch.cuda.synchronize()
        rates[label].append(reps * B / (time.perf_counter() - t0))
    print(json.dumps({"scene_clips_per_s_B8": rates}))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from audiossl_tpu_torch.kernels import build as kb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    # plain f32 references run in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    kb.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")

    res = kernel_checks(dev)
    with tempfile.TemporaryDirectory() as workdir:
        launches = main_path(dev, workdir)

    sources = {
        "mel_db": ("audiossl_tpu_torch/csrc/mel_db.cu",
                   "audiossl_tpu/ops/pallas_mel.py:39"),
        "attn_block": ("audiossl_tpu_torch/csrc/attn_block.cu",
                       "audiossl_tpu/ops/pallas_block.py:282"),
        "mlp_block": ("audiossl_tpu_torch/csrc/mlp_block.cu",
                      "audiossl_tpu/ops/pallas_block.py:360"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **res[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
