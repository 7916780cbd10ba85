"""Capture and summarize a device profile of the headline pretraining step
(port of ``scripts/profile_step.py``).

Runs the ATST-Frame base bf16 step (or ``--clip``: ATST-Clip small) for
four warm-up steps, then ``--steps`` steps under ``torch.profiler`` (CUDA
activity), and prints the device time per step of each kernel and of its
group:

* the port's hand-written kernels, matched by name against the kernels
  the port's library holds (the entry functions of the build log, or of
  ``csrc/`` where nothing was built);
* library GEMMs (cuBLAS, cuBLASLt, cuDNN, CUTLASS);
* copies and layout (memcpy, memset, copy, cat, transpose kernels);
* aten reductions and elementwise kernels; any other kernel under its
  own name.

The groups add up to the device total. A profiler window may keep fewer
records than launches (on the H100 some windows keep 9 of 10), so each
kernel's time per step is its mean over the records kept times its
launches a step, and the summary says how many records were kept.

Beside the groups it prints the step's spans (``utils/spans.py``: the
step and its phases), each with its device ms a step and the device's idle
ms a step put down to it: each stretch with no kernel or copy goes to the
innermost span the host was in at its middle.

With ``--device cpu`` (the CPU tests, with ``--tiny``) the same step runs
through the kernels' plain versions and the CPU's operator times are
summarized instead, the spans by their host ms.

Usage:
    python -m audiossl_tpu_torch.tools.profile_step [--steps 8]
        [--batch 96] [--top 40] [--keep DIR] [--filter REGEX]
    python -m audiossl_tpu_torch.tools.profile_step --clip
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import time
from pathlib import Path

import numpy as np
import torch

from audiossl_tpu_torch.tools import add_device_flag, device_of
from audiossl_tpu_torch.utils import spans

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def build_frame_step(B, teacher_quant="none", student_quant="none",
                     device="cuda", tiny=False):
    """JAX's ``build_frame_step``: ATST-Frame base, 10 s, block masks 0.65
    of span 5, the student augmented, bf16 (``tiny``: the tiny arch)."""
    from audiossl_tpu_torch.methods.atstframe.method import (
        FrameMethod, FramePretrainConfig)
    from audiossl_tpu_torch.training.pretrain import OptimizerConfig

    cfg = FramePretrainConfig(
        arch="tiny" if tiny else "base", anchor_len=10.0, mask_type="block",
        mask_ratio=0.65, mask_len=5, aug_tea=False, aug_stu=True,
        optimizer=OptimizerConfig(learning_rate=8e-5, warmup_steps=19900,
                                  max_steps=398000, ema=0.9996),
        dtype="bfloat16", teacher_quant=teacher_quant,
        student_quant=student_quant)
    method = FrameMethod(cfg, device=device)
    return method.make_step(), method.init_state(0), _batch(
        B, cfg.out_samples, 160000, method.device)


def build_clip_step(B, device="cuda", tiny=False):
    """JAX's ``build_clip_step``: ATST-Clip small, two 6 s crops, bf16."""
    from audiossl_tpu_torch.methods.atst.method import (ClipMethod,
                                                        ClipPretrainConfig)
    from audiossl_tpu_torch.training.pretrain import OptimizerConfig

    cfg = ClipPretrainConfig(
        arch="tiny" if tiny else "small", anchor_len=(6.0, 6.0),
        positive_len=(6.0, 6.0),
        optimizer=OptimizerConfig(learning_rate=5e-4, warmup_steps=1300,
                                  max_steps=39100, ema=0.99),
        dtype="bfloat16")
    method = ClipMethod(cfg, device=device)
    return method.make_step(), method.init_state(0), _batch(
        B, 160000, 160000, method.device)


def _batch(B, samples, valid, device):
    rng = np.random.RandomState(0)
    wav = torch.from_numpy(rng.randn(B, samples).astype(np.float32) * 0.1)
    return {"wav": wav.to(device),
            "valid": torch.full((B,), valid, dtype=torch.int32,
                                device=device)}


# ---------------------------------------------------------------- names
def _mangled_identifier(name: str) -> str:
    """The function's own name in an Itanium-mangled symbol
    (``_Z13mel_db_kernelPKf...`` -> ``mel_db_kernel``; nested names and
    internal linkage's ``L`` included)."""
    i = 2
    nested = name[i:i + 1] == "N"
    i += nested
    last = ""
    while i < len(name):
        while name[i:i + 1] in ("L", "K", "V"):
            i += 1
        m = re.match(r"\d+", name[i:])
        if not m:
            break
        n = int(m.group())
        i += len(m.group())
        last = name[i:i + n]
        i += n
        if not nested or name[i:i + 1] in ("E", "I"):
            break
    return last


def kernel_identifier(name: str) -> str:
    """A kernel's own function name, from a demangled name (``void
    attn::attn_fwd_mma_kernel<...>(...)`` -> ``attn_fwd_mma_kernel``) or a
    mangled one: the outermost name with its template arguments,
    parameters, return type and namespaces taken off."""
    if name.startswith("_Z"):
        return _mangled_identifier(name)
    keep, stack = [], []
    for i, ch in enumerate(name):
        if ch in "(<":
            stack.append(ch)
        elif ch == ")" and "(" in stack:
            while stack.pop() != "(":
                pass
        elif ch == ">" and stack and stack[-1] == "<" \
                and name[i - 1:i] != "-":
            stack.pop()
        elif not stack:
            keep.append(ch)
    words = "".join(keep).split()
    return words[-1].split("::")[-1] if words else name


def source_kernel_names(csrc: Path = CSRC) -> frozenset:
    """The names of the ``__global__`` functions in the port's CUDA
    sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    return frozenset(m.group(1) for f in sorted(csrc.glob("*.cu*"))
                     for m in pat.finditer(f.read_text()))


def library_kernel_names() -> frozenset:
    """The names of the kernels the built library holds: the entry
    functions its build log lists (``kernels/build.py`` keeps the
    compiler's ``-Xptxas -v`` output beside the library)."""
    from audiossl_tpu_torch.kernels import build as kb

    lib = kb.build()
    digest = lib.name[len("libaudiossl_kernels_"):-len(".so")]
    log = (lib.parent / f"{digest}.log").read_text()
    return frozenset(_mangled_identifier(m) for m in re.findall(
        r"Compiling entry function '(\w+)'", log))


# --------------------------------------------------------------- totals
def device_op_totals(prof, steps: int, cpu: bool = False,
                     skip=frozenset()):
    """Per kernel name -> ms per step from a ``torch.profiler`` run of
    ``steps`` steps: the mean over the records kept, times the kernel's
    launches a step (its records over ``steps``, rounded, at least 1).
    Returns (totals, records kept, records expected). ``cpu``: the CPU
    operators' self times (a run on the CPU); otherwise the device's
    events alone, so a profile that also traced the CPU counts each
    kernel once. Names in ``skip`` (the spans' ranges) are left out."""
    from torch.autograd import DeviceType

    totals, kept, expected = {}, 0, 0
    for e in prof.key_averages():
        if not cpu and getattr(e, "device_type", None) == DeviceType.CPU:
            continue
        if e.key in skip:  # the spans' ranges
            continue
        us = e.self_cpu_time_total if cpu else e.self_device_time_total
        if us <= 0 or not e.count:
            continue
        per_step = max(1, round(e.count / steps))
        totals[e.key] = us / e.count * per_step / 1e3
        kept += e.count
        expected += max(e.count, per_step * steps)
    return totals, kept, expected


LIBRARY_GEMM = re.compile(r"gemm|gemv|cublas|cutlass|xmma|nvjet|cudnn|"
                          r"splitKreduce|sm\d\d_|dot_kernel|fmha|flash",
                          re.IGNORECASE)
COPIES = re.compile(r"Memcpy|Memset|copy|Copy|CatArray|\bcat_|transpose|"
                    r"permute|contiguous")
REDUCTIONS = re.compile(r"reduce|Reduce|[Ss]oft[Mm]ax|norm|Norm|[Ss]um|"
                        r"[Mm]ean|[Ss]can|[Ss]ort|topk|argmax")
ELEMENTWISE = re.compile(r"elementwise|vectorized|unrolled|pointwise",
                         re.IGNORECASE)

HAND_WRITTEN = "hand-written (audiossl_tpu_torch)"
GROUPS = [
    # matched in order; the hand-written kernels by their names alone
    ("library GEMMs (cuBLAS/cuDNN/CUTLASS)", LIBRARY_GEMM, "name"),
    ("copies/layout", COPIES, "name"),
    ("aten reductions", REDUCTIONS, "kind"),
    ("aten elementwise", ELEMENTWISE, "kind"),
]


def op_kind(name: str) -> str:
    """The op's own identity: a kernel's function name
    (:func:`kernel_identifier`), or a CPU operator's name."""
    return kernel_identifier(name) if ("(" in name or "<" in name
                                       or name.startswith("_Z")) else name


def group_of(name: str, port_names) -> str:
    """The group of a kernel (or operator) name; ``port_names`` are the
    port's own kernel names."""
    kind = op_kind(name)
    if kind in port_names and "at::" not in name:
        return HAND_WRITTEN
    for gname, pat, on in GROUPS:
        if pat.search(name if on == "name" else kind):
            return gname
    return f"op:{kind}"


def group_totals(totals: dict, port_names) -> collections.Counter:
    grouped = collections.Counter()
    for name, ms in totals.items():
        grouped[group_of(name, port_names)] += ms
    return grouped


# ---------------------------------------------------------------- spans
def device_intervals(prof):
    """(start, end) in Unix ns of every kernel, copy and memset of a
    finished profile."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def span_table(records, steps: int, intervals=None):
    """{span name: [ms a step, idle ms a step]}: the spans' device ms (host
    ms where they ran on the CPU) and, given the device's ``intervals``,
    the idle ms put down to each (``spans.idle_by_span``)."""
    table = {}
    for r in records:
        ms = r.device_ms if r.device_ms is not None \
            else (r.end_ns - r.start_ns) / 1e6
        table.setdefault(r.name, [0.0, 0.0])[0] += ms / steps
    if intervals and records:
        for name, ns in spans.idle_by_span(intervals, records).items():
            table.setdefault(name or "(no span)", [0.0, 0.0])[1] += \
                ns / 1e6 / steps
    return table


# ------------------------------------------------------------------ CLI
def build_parser():
    ap = argparse.ArgumentParser("profile_step", description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--clip", action="store_true")
    ap.add_argument("--int8-teacher", action="store_true",
                    help="profile the int8-quantized-teacher recipe variant")
    ap.add_argument("--int8-student", action="store_true",
                    help="profile the int8-student-forward recipe variant")
    ap.add_argument("--int8dx-student", action="store_true",
                    help="profile the int8 fwd + int8-dX-backward variant")
    ap.add_argument("--keep", default=None,
                    help="keep a chrome trace under this directory")
    ap.add_argument("--filter", default=None,
                    help="only show top ops whose name matches this regex")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny arch (CPU smoke runs)")
    return add_device_flag(ap)


def main(argv=None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    args = build_parser().parse_args(argv)
    dev = device_of(args)
    if args.clip:
        step, state, batch = build_clip_step(args.batch, dev, args.tiny)
    else:
        step, state, batch = build_frame_step(
            args.batch,
            teacher_quant="int8" if args.int8_teacher else "none",
            student_quant=("int8dx" if args.int8dx_student
                           else "int8" if args.int8_student else "none"),
            device=dev, tiny=args.tiny)
    cpu = dev.type == "cpu"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    for _ in range(4):          # build the kernels, fill the caches
        metrics = step(state, batch)
    float(metrics["loss"])
    sync()

    activity = ProfilerActivity.CPU if cpu else ProfilerActivity.CUDA
    spans.clear()
    t0 = time.perf_counter()
    with profile(activities=[activity]) as prof:
        for _ in range(args.steps):
            metrics = step(state, batch)
        float(metrics["loss"])
        sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.keep:
        os.makedirs(args.keep, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.keep, "trace.json"))

    records = spans.records()
    totals, kept, expected = device_op_totals(
        prof, args.steps, cpu, skip={r.name for r in records})
    port_names = source_kernel_names() if cpu else library_kernel_names()
    total_ms = sum(totals.values())
    print(f"device total: {total_ms:.2f} ms/step ({len(totals)} distinct "
          f"ops, B={args.batch}; wall {wall_ms:.2f} ms/step under the "
          f"profiler; {kept} of {expected} records kept)")
    grouped = group_totals(totals, port_names)
    print("\n== groups ==")
    for gname, ms in grouped.most_common():
        print(f"{ms:9.3f} ms  {gname}")

    print(f"\n== top {args.top} ops ==")
    items = sorted(totals.items(), key=lambda kv: -kv[1])
    if args.filter:
        pat = re.compile(args.filter)
        items = [kv for kv in items if pat.search(kv[0])]
        print(f"(filtered: {sum(ms for _, ms in items):.2f} ms total)")
    for name, ms in items[:args.top]:
        print(f"{ms:9.3f} ms  {name[:160]}")

    table = span_table(records, args.steps,
                       None if cpu else device_intervals(prof))
    print(f"\n== spans: {'host' if cpu else 'device'} ms a step, and the "
          "device's idle ms a step by the span the host was in ==")
    for name, (ms, idle) in sorted(table.items(), key=lambda kv: -kv[1][0]):
        print(f"{ms:9.3f} ms  {idle:7.3f} ms idle  {name}")
    if args.keep:
        print(f"\ntrace kept at {args.keep}")
    return {"device_ms": total_ms, "wall_ms": wall_ms, "totals": totals,
            "groups": dict(grouped), "spans": table, "records_kept": kept,
            "records_expected": expected,
            "hand_written": sorted({op_kind(k) for k in totals
                                    if group_of(k, port_names)
                                    == HAND_WRITTEN})}


if __name__ == "__main__":
    main()
