#!/usr/bin/env python3
"""Same-card comparisons: runs chosen phases of a checkout's ``chip_smoke.py``
on one CUDA GPU, so that two checkouts (this one and, say, its parent
commit unpacked with ``git archive`` into a directory ``.gitignore`` lists)
can be timed in one run, in turns:

    python3 chip_ab.py ROOT LABEL PHASE [PHASE ...]

ROOT is the checkout whose package and ``chip_smoke.py`` run (its kernels
build into ROOT/build); LABEL prefixes every line printed. Phases:

- ``gemm``: ``chip_smoke.gemm_checks`` (the GEMM phase, timed beside the
  library calls);
- ``serving``: ``chip_smoke.main_path`` (bf16 serving, clips/s in turns);
- ``serving_device``: the device time per call of K2 and K3 at the serving
  shape [8, 250, 768] (``torch.profiler``, 50 calls after 5), which the
  host's speed does not move;
- ``clip_bf16``, ``clip_f32``, ``frame_bf16``, ``frame_f32``: the
  training-step paths of ``chip_smoke.py`` (clips/s in turns).
"""
import os
import sys
import tempfile

import numpy as np
import torch


def serving_device(dev, label):
    from torch.profiler import ProfilerActivity, profile

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

    for _ in range(5):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            run()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        name = e.key.split("(")[0][-60:]
        us[name] = us.get(name, 0.0) + e.self_device_time_total / 50
    us = {k: v for k, v in us.items() if v > 0}
    print(f"{label} K2 + K3 device us per call at [8, 250, 768]: total "
          f"{sum(us.values())}; " + ", ".join(
              f"{k} {v}" for k, v in sorted(us.items(), key=lambda kv: -kv[1])))


def main():
    root, label, phases = os.path.abspath(sys.argv[1]), sys.argv[2], sys.argv[3:]
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
        else:
            paths[phase](dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
