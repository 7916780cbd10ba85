"""Readings the limits of ``correct`` are set from: one cell's comparison
with the reference over many seeds in one process, for the program as the
configuration states it, for the control (``--control``: the next lower
precision) or with a fault planted (``--fault``). Each seed prints one JSON
line. Not part of a benchmark run.

    python3 benchmark/calibrate.py --workload frame_base.pretrain_bf16 \\
        --seeds 11,12,13 [--control | --fault half_batch] [--seconds 1]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    run.cache_dirs()
    sys.path[:0] = [str(run.BENCH), str(run.ROOT)]
    import contextlib

    import torch

    from harness import faults

    c = run.cell(args.workload)
    device = torch.device("cuda", 0)
    cm = (faults.planted(c["traffic"]["mix"], args.fault) if args.fault
          else contextlib.nullcontext())
    with cm:
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            out, metrics, correct, checks = run.execute(
                c, seed, args.seconds, False, device, control=args.control,
                fault=args.fault)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "control": args.control, "fault": args.fault,
                "correct": correct, "numbers": out.numbers,
                "attempted": out.attempted, "seconds": time.perf_counter() - t,
                "metrics": {k: v["value"] for k, v in metrics.items()}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
