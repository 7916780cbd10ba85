#!/usr/bin/env python3
"""Same-card comparisons: runs chosen phases of a checkout's ``chip_smoke.py``
on one CUDA GPU, so that two checkouts (this one and, say, its parent
commit unpacked with ``git archive`` into a directory ``.gitignore`` lists)
can be timed in one run, in turns:

    python3 chip_ab.py ROOT LABEL [--profile DIR] PHASE [PHASE ...]

ROOT is the checkout whose package and ``chip_smoke.py`` run (its kernels
build into ROOT/build); LABEL prefixes every line printed. Phases:

- ``gemm``: ``chip_smoke.gemm_checks`` (the GEMM phase, timed beside the
  library calls);
- ``serving``: ``chip_smoke.main_path`` (bf16 serving, clips/s in turns);
- ``serving_device``: the device time per call of K2 and K3 at the serving
  shape [8, 250, 768] (``torch.profiler``, 50 calls after 5), which the
  host's speed does not move;
- ``clip_bf16``, ``clip_f32``, ``frame_bf16``, ``frame_f32``: the
  training-step paths of ``chip_smoke.py`` (clips/s in turns); after
  ``--profile DIR`` (before the phases) the three that take one write a
  profile of one step to DIR/LABEL (``chip_smoke.profile_step``);
- ``k1``, ``k7``, ``k8``: K1 at the main paths' STFT shapes, K7 over the
  ATST-Frame base student's leaves and K8 at the training shapes, ms per
  call by CUDA events and on the device (K1 and K7 also the host's time to
  issue a call);
- ``rates``: clips/s of the four steps' kernel paths alone, 5 turns each.
"""
import os
import sys
import tempfile

import numpy as np
import torch


def device_ms(fn, match=None, iters=50, warmup=5, launches=1):
    """Device time per call of ``fn`` by kernel name (``torch.profiler``:
    self CUDA time of the events whose names hold one of ``match``, or of
    every event), which the host's speed does not move. A window may keep
    fewer records than launches, so each kernel's time is its mean over
    the records kept times its launches a call (its records over
    ``iters``, rounded, at least 1); those must add up to ``launches``
    when ``match`` is given, and each kernel must keep half its records,
    else the window is profiled again, twice at most, then refused."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.self_device_time_total > 0
                and (match is None or any(m in e.key for m in match))]
        per_call = [max(1, round(e.count / iters)) for e in seen]
        if (seen and all(2 * e.count >= iters * n
                         for e, n in zip(seen, per_call))
                and (match is None or sum(per_call) == launches)):
            break
        print(f"device_ms: {[e.count for e in seen]} records of "
              f"{match or 'the call'} over {iters} calls; profiling again",
              flush=True)
    else:
        raise RuntimeError(f"the profiler dropped records of {match} in "
                           "three windows")
    us = {}
    for e, n in zip(seen, per_call):
        if e.count != iters * n:
            print(f"device_ms: {e.count} records of {e.key[:60]} over "
                  f"{iters} calls; timed as their mean", flush=True)
        name = e.key.split("(")[0][-60:]
        us[name] = us.get(name, 0.0) + e.self_device_time_total / e.count * n
    return {k: v / 1e3 for k, v in us.items()}


def serving_device(dev, label):
    from audiossl_tpu_torch.ops import block_infer as bi

    rng = np.random.RandomState(0)

    def t(*shape, s=1.0, off=0.0, dtype=torch.float32):
        a = (rng.randn(*shape) * s + off).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    bf = torch.bfloat16
    x = t(8, 250, 768, dtype=bf)
    valid, dp = torch.ones(8, 250, device=dev), torch.ones(8, device=dev)
    ln = [t(768, s=0.1, off=1.0), t(768, s=0.1)]
    attn = (t(2304, 768, s=0.03, dtype=bf), t(2304, s=0.02),
            t(768, 768, s=0.03, dtype=bf), t(768, s=0.02))
    mlp = (t(3072, 768, s=0.03, dtype=bf), t(3072, s=0.02),
           t(768, 3072, s=0.03, dtype=bf), t(768, s=0.02))

    def run():
        bi.attn_block_infer(x, valid, *ln, *attn, 12, dp=dp)
        bi.mlp_block_infer(x, *ln, *mlp, dp=dp)

    us = {k: v * 1e3 for k, v in device_ms(run).items()}
    print(f"{label} K2 + K3 device us per call at [8, 250, 768]: total "
          f"{sum(us.values())}; " + ", ".join(
              f"{k} {v}" for k, v in sorted(us.items(), key=lambda kv: -kv[1])))


def k1(dev, label, cs):
    """K1 at the serving, clip-inference, frame-step and clip-step STFT
    shapes ([8 or 96, 1026, 1001 or 601]) on the STFT of seeded waveforms:
    ms per call by CUDA events (back to back, the host included), on the
    device, and the host's time to issue a call."""
    import time

    from audiossl_tpu_torch.ops.mel_db import stft_to_mel_db
    from audiossl_tpu_torch.ops.melspec import MelConfig, mel_filterbank, stft_conv

    rng = np.random.RandomState(11)
    cfg = MelConfig()
    fb = mel_filterbank(cfg, dev)
    for b, frames in ((8, 1001), (8, 601), (96, 1001), (96, 601)):
        wav = torch.from_numpy((rng.randn(b, (frames - 1) * 160) * 0.1).astype(
            np.float32)).to(dev)
        stft = stft_conv(wav, cfg)

        def fn():
            stft_to_mel_db(stft, fb, cfg.amin)

        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        dev_ms = sum(device_ms(fn, ("mel_db_kernel",), iters=20).values())
        print(f"{label} K1 {list(stft.shape)}: events {cs.cuda_ms(fn)} ms, "
              f"device {dev_ms} ms, host {host} ms")
        del wav, stft
        torch.cuda.empty_cache()


def k7(dev, label, cs):
    """K7 over the ATST-Frame base student's leaves: ms per call by CUDA
    events (back to back, the host included), on the device, and the
    host's time to issue a call. A checkout whose wrapper keeps a leaf
    table gets one, as its training step does."""
    import time

    from audiossl_tpu_torch.ops import adamw_ema as ae

    shapes, teacher, decay = cs.student_leaves(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda s, sc: torch.randn(s, device=dev, generator=gen) * sc  # noqa: E731
    p, g, mu = ([r(s, 0.02) for s in shapes] for _ in range(3))
    nu = [r(s, 1e-6).abs() for s in shapes]
    t = [r(s, 0.02) if keep else None for s, keep in zip(shapes, teacher)]
    sc = ae.update_scalars(8e-5, 0.04, 0.9996, 7, 0.9, 0.999, 1e-6)
    kw = {"table": ae.LeafTable()} if hasattr(ae, "LeafTable") else {}

    def fn():
        ae.adamw_ema(p, g, mu, nu, t, decay, sc, **kw)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    dev_ms = sum(device_ms(fn, ("adamw_ema_kernel",), iters=10).values())
    print(f"{label} K7 ms per call: events {cs.cuda_ms(fn, iters=10)}, "
          f"device {dev_ms}, host {host}")


def k8(dev, label, cs):
    """K8 at the f32 and bf16 training shapes: ms per call by CUDA events
    and on the device."""
    from audiossl_tpu_torch.ops import layer_norm as ln

    rng = np.random.RandomState(7)
    for dtype, rows, c in ((torch.float32, 28992, 384),
                           (torch.float32, 48000, 768),
                           (torch.bfloat16, 28992, 384),
                           (torch.bfloat16, 48000, 768)):
        x = torch.from_numpy((rng.randn(rows, c) * 2 + 0.3).astype(
            np.float32)).to(dev, dtype)
        g = torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(
            dev, dtype)
        sc = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(dev)

        def fn():
            ln.ln_bwd(x, g, sc, 1e-6)

        dev_ms = sum(device_ms(fn, ("ln_pg_",), iters=20,
                                launches=2).values())
        print(f"{label} K8 [{rows}, {c}] {dtype}: events "
              f"{cs.cuda_ms(fn, iters=20)} ms, device {dev_ms} ms")


def rates(dev, label, cs):
    """clips/s of the kernel-path training steps alone (no checks, no
    plain-version step) at the recipes of ``chip_smoke.py``'s step paths:
    per recipe one warm-up step, then 5 turns of 3 steps, each turn timed
    to ``torch.cuda.synchronize()``."""
    import time

    from audiossl_tpu_torch.methods.atst.method import ClipMethod
    from audiossl_tpu_torch.methods.atstframe.method import (
        FrameMethod, FramePretrainConfig)

    recipes = {
        "frame_bf16": (FrameMethod, cs.base_recipe(), 4),
        "clip_f32": (ClipMethod, cs.clip_recipe("float32"), 8),
        "clip_bf16": (ClipMethod, cs.clip_recipe("bfloat16"), 9),
        "frame_f32": (FrameMethod, FramePretrainConfig(arch="base"), 10),
    }
    for name, (cls, cfg, seed) in recipes.items():
        m = cls(cfg, device=dev, seed=cs.SEED)
        st = m.init_state(seed=cs.SEED)
        st.step = cfg.optimizer.warmup_steps
        step = m.make_step()
        batch = (cs.wav_batch(dev, cfg.out_samples, cs.SEED + seed)
                 if cls is FrameMethod else
                 cs.wav_batch(dev, cs.SAMPLES, cs.SEED + seed, short=80000))
        step(st, batch)
        torch.cuda.synchronize()
        out = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(3):
                step(st, batch)
            torch.cuda.synchronize()
            out.append(3 * cs.TRAIN_B / (time.perf_counter() - t0))
        print(f"{label} {name} clips/s B96: {out}", flush=True)
        del m, st, step, batch
        torch.cuda.empty_cache()


def main():
    root, label, phases = os.path.abspath(sys.argv[1]), sys.argv[2], sys.argv[3:]
    profile_dir = None
    if phases[:1] == ["--profile"]:
        profile_dir, phases = os.path.join(os.path.abspath(phases[1]),
                                           label), phases[2:]
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from audiossl_tpu_torch.kernels import build as kb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kb.library()
    paths = {"clip_bf16": cs.clip_bf16_path, "clip_f32": cs.clip_f32_path,
             "frame_bf16": cs.frame_bf16_path, "frame_f32": cs.frame_f32_path}
    for phase in phases:
        print(f"{label} phase {phase}", flush=True)
        if phase == "gemm":
            cs.gemm_checks(dev)
        elif phase == "serving":
            with tempfile.TemporaryDirectory() as workdir:
                cs.main_path(dev, cs.write_base_ckpt(workdir))
        elif phase == "serving_device":
            serving_device(dev, label)
        elif phase in ("k1", "k7", "k8", "rates"):
            {"k1": k1, "k7": k7, "k8": k8, "rates": rates}[phase](dev, label,
                                                               cs)
        elif profile_dir and phase != "clip_bf16":
            paths[phase](dev, profile_dir)
        else:
            paths[phase](dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
