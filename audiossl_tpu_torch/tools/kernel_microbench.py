"""Microbenchmark the whole-block inference kernels, bf16 against int8, at
production shapes (port of ``scripts/kernel_microbench.py``): K2/K3
(``csrc/attn_block.cu``, ``csrc/mlp_block.cu``) against K2q/K3q on the
same random weights (``RandomState(0)``, JAX's draws in JAX's order),
each timed by CUDA events (the best of 3 runs of ``--iters`` calls), its
TF/s equivalent by JAX's operation counts, the int8 kernels' speedup, and
their mean and largest error relative to the bf16 output's mean
magnitude. A kernel that fails to build or launch raises.

Usage:
    python -m audiossl_tpu_torch.tools.kernel_microbench [--batch 96]
        [--seq 256] [--dim 768] [--heads 12] [--iters 30]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from audiossl_tpu_torch.tools import add_device_flag, device_of


def _time(fn, iters=30, cuda=True):
    """(best ms per call over 3 runs of ``iters`` calls, the last
    output): CUDA events on the card, the host's clock on the CPU."""
    out = fn()
    best = float("inf")
    for _ in range(3):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best, out


def build_parser():
    ap = argparse.ArgumentParser("kernel_microbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--tiny", action="store_true",
                    help="[2, 16, 64], 2 heads (CPU smoke runs)")
    return add_device_flag(ap)


def make_inputs(B, N, C, device):
    """JAX's weights and input: ``RandomState(0)`` draws qkv [C, 3C], proj
    [C, C], fc1 [C, 4C], fc2 [4C, C] (std 0.02), then x [B, N, C] (std 1,
    in bf16); unit LN scales, zero biases, no qkv bias. Weights returned
    in torch's [out, in] layout, f32."""
    rng = np.random.RandomState(0)

    def rnd(*shape, scale=0.02):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)

    w = {"qkv": rnd(C, 3 * C).t(), "proj": rnd(C, C).t(),
         "fc1": rnd(C, 4 * C).t(), "fc2": rnd(4 * C, C).t()}
    x = rnd(B, N, C, scale=1.0).to(torch.bfloat16)
    w = {k: v.contiguous().to(device) for k, v in w.items()}
    zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
    ones = lambda n: torch.ones(n, device=device)  # noqa: E731
    return x.to(device), w, dict(ln_w=ones(C), ln_b=zeros(C),
                                 b_proj=zeros(C), b1=zeros(4 * C),
                                 b2=zeros(C))


def block_fns(x, w, p, H, quant):
    """The attention and MLP halves (K2/K3, or with ``quant`` K2q/K3q on
    the codes of the same weights) as functions of nothing."""
    from audiossl_tpu_torch.ops import block_infer as bi
    from audiossl_tpu_torch.ops.quant import quantize_weight_q8

    B, N, _ = x.shape
    valid = torch.ones(B, N, device=x.device)
    if quant:
        q = {k: quantize_weight_q8(v) for k, v in w.items()}
        return (lambda: bi.attn_block_infer_q8(
                    x, valid, p["ln_w"], p["ln_b"], *q["qkv"], None,
                    *q["proj"], p["b_proj"], H),
                lambda: bi.mlp_block_infer_q8(
                    x, p["ln_w"], p["ln_b"], *q["fc1"], p["b1"], *q["fc2"],
                    p["b2"]))
    wb = {k: v.to(torch.bfloat16) for k, v in w.items()}
    return (lambda: bi.attn_block_infer(
                x, valid, p["ln_w"], p["ln_b"], wb["qkv"], None, wb["proj"],
                p["b_proj"], H),
            lambda: bi.mlp_block_infer(
                x, p["ln_w"], p["ln_b"], wb["fc1"], p["b1"], wb["fc2"],
                p["b2"]))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = device_of(args)
    B, N, C, H = ((2, 16, 64, 2) if args.tiny else
                  (args.batch, args.seq, args.dim, args.heads))
    x, w, p = make_inputs(B, N, C, dev)
    flops_attn = 2 * B * N * C * (4 * C) + 4 * B * H * N * N * (C // H)
    flops_mlp = 4 * B * N * C * 4 * C

    results, outs = {}, {}
    for quant in (None, "int8"):
        tag = quant or "bf16"
        fa, fm = block_fns(x, w, p, H, quant)
        ta, oa = _time(fa, args.iters, dev.type == "cuda")
        tm, om = _time(fm, args.iters, dev.type == "cuda")
        outs[tag] = (oa, om)
        results[tag] = {"attn_ms": ta, "mlp_ms": tm,
                        "attn_tflops": flops_attn / ta / 1e9,
                        "mlp_tflops": flops_mlp / tm / 1e9}
        print(f"attn[{tag}]: {ta:7.3f} ms  "
              f"{flops_attn / ta / 1e9:6.1f} TF/s(eq)")
        print(f"mlp [{tag}]: {tm:7.3f} ms  "
              f"{flops_mlp / tm / 1e9:6.1f} TF/s(eq)")

    rel = {}
    for i, half in enumerate(("attn", "mlp")):
        b = outs["bf16"][i].float()
        d = (outs["int8"][i].float() - b).abs()
        den = float(b.abs().mean()) + 1e-9
        rel[f"{half}_mean"] = float(d.mean()) / den
        rel[f"{half}_max"] = float(d.max()) / den
    results["speedup"] = {
        h: results["bf16"][f"{h}_ms"] / results["int8"][f"{h}_ms"]
        for h in ("attn", "mlp")}
    results["int8_rel_err"] = rel
    results["shape"] = [B, N, C, H]
    print(f"speedup: attn {results['speedup']['attn']:.2f}x  "
          f"mlp {results['speedup']['mlp']:.2f}x")
    print(f"int8 rel err: attn mean {rel['attn_mean']:.4f} "
          f"max {rel['attn_max']:.4f}; "
          f"mlp mean {rel['mlp_mean']:.4f} max {rel['mlp_max']:.4f}")
    return results


if __name__ == "__main__":
    main()
