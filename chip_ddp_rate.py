#!/usr/bin/env python3
"""Data-parallel rate of the frame CLI's run loop on the cards of one
host: the ATST-Frame base recipe (``recipes/torch_atst_frame_base.sh``'s
arguments through the CLI's parser and ``build_method``, bf16) at 96 clips
a card, on 1 card and on every card (NCCL, the ranks started as the CLI's
``--n_devices`` starts them), in turns (1, n with ``--turns 1``; 1, n, n, 1
with ``--turns 2``).

    python3 chip_ddp_rate.py [--steps 12] [--log 3] [--turns 1]

Writes a seeded int16 pack of tone clips of 2-10 s (5 global batches an
epoch at every card), runs each turn in a process of its own (``--run
N``), and prints each run's clips/s by log interval (the global batch's),
the median of the intervals after the first, the card's name and power
limit, and a JSON line. Needs two cards or more; exits 2 otherwise.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

PER_CARD = 96
ROOT = os.path.dirname(os.path.abspath(__file__))


def recipe_args(data, ranks, steps):
    """The frame CLI's arguments for the recipe at ``ranks`` cards."""
    from audiossl_tpu_torch.methods.atstframe import train as ft

    with open(os.path.join(ROOT, "recipes", "torch_atst_frame_base.sh")) as f:
        line = next(ln for ln in f.read().replace("\\\n", " ").splitlines()
                    if ln.strip().startswith("python"))
    argv = [a.strip('"') for a in line.split()[3:]]
    i = argv.index("--save_path")
    del argv[i:i + 2]  # no checkpoints
    argv = [data if a == "$DATA" else a for a in argv]
    return ft.build_parser().parse_args(argv + [
        "--n_devices", str(ranks), "--batch_size_per_device", str(PER_CARD),
        "--warmup_steps", "2", "--max_steps", str(steps)])


def train(args):
    """One rank of the frame CLI's ``train`` with a log interval."""
    from audiossl_tpu_torch.datasets import PackedAudioDataset
    from audiossl_tpu_torch.methods.atstframe import train as ft
    from audiossl_tpu_torch.training.runner import run_pretraining

    run_pretraining(
        ft.build_method(args), PackedAudioDataset(args.data_path, "train",
                                                  subset=args.subset),
        batch_size_per_device=args.batch_size_per_device,
        max_steps=args.max_steps, log_interval=args.log, seed=args.seed,
        n_devices=args.n_devices, clip_len_s=args.clip_len)


def run(ranks, data, steps, log):
    from audiossl_tpu_torch.parallel.launch import run_cli

    args = recipe_args(data, ranks, steps)
    args.log = log
    run_cli(train, args)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--log", type=int, default=3)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--run", type=int, default=None,
                    help="one run on this many cards (a turn's process)")
    ap.add_argument("--data", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.run is not None:
        return run(args.run, args.data, args.steps, args.log)
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"chip_ddp_rate: {n} card(s); it needs 2 or more",
              file=sys.stderr)
        return 2
    from audiossl_tpu_torch.datasets import write_synthetic_pack
    from audiossl_tpu_torch.kernels import build as kb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    cards = smi.stdout.strip().splitlines()
    print("\n".join(cards))
    kb.library()  # built once, before any run loads it
    results = {"cards": cards, "per_card": PER_CARD, "steps": args.steps,
               "runs": []}
    order = [1, n] if args.turns == 1 else [1, n, n, 1] * (args.turns // 2)
    with tempfile.TemporaryDirectory() as wd:
        data = os.path.join(wd, "pack")
        t0 = time.perf_counter()
        write_synthetic_pack(data, "train", 5 * n * PER_CARD, min_s=2.0,
                             max_s=10.0, seed=30, kind="tones")
        print(f"pack of {5 * n * PER_CARD} clips in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for ranks in order:
            cmd = [sys.executable, os.path.abspath(__file__), "--run",
                   str(ranks), "--data", data, "--steps", str(args.steps),
                   "--log", str(args.log)]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=1800)
            wall = time.perf_counter() - t0
            if r.returncode:
                print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"the run on {ranks} card(s) failed")
            rates = [float(x) for x in re.findall(
                r"^step \d+ .*clips_per_sec=([\d.e+-]+)", r.stdout, re.M)]
            loader = re.search(r"^loader: (.*)$", r.stdout, re.M).group(1)
            steady = sorted(rates[1:])[len(rates[1:]) // 2]
            results["runs"].append({
                "cards": ranks, "global_batch": ranks * PER_CARD,
                "clips_per_s_by_interval": rates,
                "median_after_first": steady, "wall_s": wall,
                "loader": loader})
            print(f"{ranks} card(s), global batch {ranks * PER_CARD}: "
                  f"clips/s by interval {rates}, median after the first "
                  f"{steady}; {wall:.1f} s; loader {loader}", flush=True)
    by = {}
    for r in results["runs"]:
        by.setdefault(r["cards"], []).append(r["median_after_first"])
    results["speedup_range"] = [min(by[n]) / max(by[1]),
                                max(by[n]) / min(by[1])]
    print(json.dumps({"ddp_rate": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
