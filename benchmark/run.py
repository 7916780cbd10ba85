"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout: reads ``BENCHMARK.json``, finds the cell's
configuration (its ``file``), its traffic (``benchmark/traffic/<traffic>.json``,
whose ``mix`` names a module of ``benchmark/mixes/``), its limits
(``benchmark/limits/<workload>.json``) and, with ``--trace 1``, a reader
``benchmark/metrics/<metric>.py`` for each per-layer metric of the cell.
Builds, warms up, measures for ``--seconds``, holds what the timed path
produced against the plain reference, and prints one JSON object as the
last line of standard output; the numbers compared, each with its limit,
go last on standard error and last in that line.

It runs on the card or not at all: with no CUDA device, or fewer than the
cell asks for, it exits with code 2 and prints no result. It exits with
code 3, printing no result, if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audiossl_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ.setdefault("USE_FLAX", "0")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, root: Path = ROOT) -> dict:
    """Everything the benchmark's files under ``root`` say of ``workload``."""
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in spec["workloads"]}
    if workload not in wl:
        raise SystemExit(f"unknown workload {workload!r}")
    w = wl[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    layer = [m for m in spec["per_layer"] if listed(m)
             and any(e["name"] == m["moves"] for e in e2e)]
    return {"entry": w, "config": config, "traffic": traffic,
            "limits": limits["limits"], "e2e": e2e, "per_layer": layer,
            "bench": bench}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def device_info(n_chips: int, outcome, trace_on: bool) -> dict:
    import torch

    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": n_chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    if trace_on:  # averaged over the chips used
        from harness import trace

        trs = outcome.traces
        d["busy_s"] = sum(trace.busy_seconds(t.device, t.window)
                          for t in trs) / len(trs)
        d["window_s"] = sum(t.window_s for t in trs) / len(trs)
    return d


def execute(c: dict, seed: int, seconds: float, trace_on: bool, device,
            control: bool = False, t0: float = None, fault: str = None):
    """Runs the cell's mix; -> (outcome, metrics, correct, checks)."""
    from harness import compare
    from harness.context import Ctx

    mix = load_module(c["bench"] / "mixes" / f"{c['traffic']['mix']}.py",
                      f"mix_{c['traffic']['mix']}")
    ctx = Ctx(workload=c["entry"]["name"], config=c["config"],
              traffic=c["traffic"], seed=seed, seconds=seconds,
              trace=trace_on, device=device, control=control, fault=fault,
              t0=time.perf_counter() if t0 is None else t0)
    out = mix.run(ctx)
    metrics = {}
    if trace_on:
        for m in c["per_layer"]:
            reader = load_module(c["bench"] / "metrics" / f"{m['name']}.py",
                                 "metric_" + m["name"].replace(".", "_"))
            v = reader.read(out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c["e2e"]:
            v = out.setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ok, checks = compare.judge(out.numbers, c["limits"])
    correct = ok and out.failed == 0 and out.attempted > 0
    return out, metrics, correct, checks


def result_line(out, metrics, correct, checks, device: dict) -> dict:
    """The result's line: the numbers compared come last."""
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if out.trace is not None:
        from harness import trace

        line["breakdown"] = trace.breakdown(out.trace)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    c = cell(args.workload)

    import torch

    chips = c["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out, metrics, correct, checks = execute(c, args.seed, args.seconds,
                                            bool(args.trace), device, t0=T0)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    line = result_line(out, metrics, correct, checks,
                       device_info(chips, out, bool(args.trace)))
    for name, v in checks.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
