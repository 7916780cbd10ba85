"""The traced stretch of a run: what the device did, from ``torch.profiler``.

Device events are the profiler's raw records (kernels, copies, memsets) with
their start and end. The window is the span of a host annotation around the
profiled units, so the idle share counts the gaps the host leaves as well
as those between kernels. A profile may keep fewer records than launches
(about 1 in 3,000 goes missing on the H100), so times by kernel are the mean
over the records kept times the launches (the records per unit, rounded,
times the units), as ``tools/profile_step.py`` takes them.

Kernel launches of the measured program's own library are recorded by
wrapping its one call path (``kernels.build.call``): the name of the C entry
point and the integer arguments, which carry every shape.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


@dataclasses.dataclass
class Event:
    kind: str     # kernel | gpu_memcpy | gpu_memset | cpu_op | ...
    name: str
    start: float  # seconds
    end: float


@dataclasses.dataclass
class Trace:
    """One profiled stretch of ``units`` steps or calls."""
    units: int
    window: Tuple[float, float]
    device: List[Event]
    host: List[Event]
    launches: List[Tuple[str, Tuple[int, ...]]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _get(e, attr):
    v = getattr(e, attr)
    return v() if callable(v) else v


def events_of(prof) -> Tuple[List[Event], List[Event], Tuple[float, float]]:
    """(device events, host operators, window) from a finished profile."""
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = _get(e, "name")
        start = _get(e, "start_ns") * 1e-9
        end = start + _get(e, "duration_ns") * 1e-9
        on_device = str(_get(e, "device_type")).endswith("CUDA")
        if _get(e, "is_user_annotation"):
            if not on_device and name == WINDOW:
                window = (start, end)
        elif on_device:
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            dev.append(Event(kind, name, start, end))
        else:
            host.append(Event("cpu_op", name, start, end))
    if window is None:
        raise RuntimeError("the profile holds no window annotation")
    dev = [e for e in dev if e.end > window[0] and e.start < window[1]]
    return dev, host, window


@contextlib.contextmanager
def record_launches(out: list):
    """Appends (entry point, integer arguments) of every launch of the
    program's kernel library to ``out`` while open."""
    from audiossl_tpu_torch.kernels import build as kb

    call = kb.call

    def recorded(name, device, *args):
        out.append((name, tuple(a for a in args if type(a) is int)))
        return call(name, device, *args)

    kb.call = recorded
    try:
        yield out
    finally:
        kb.call = call


def profile_units(fn, units: int) -> Trace:
    """Runs ``fn()`` ``units`` times under the profiler (host operators and
    device activity) inside the window annotation, ending on a synchronize.
    One unit runs under the profiler before the window opens, so that the
    profiler's own start-up falls outside it."""
    from torch.profiler import ProfilerActivity, profile

    launches: list = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_launches(launches):
            with torch.profiler.record_function(WINDOW):
                for _ in range(units):
                    fn()
                torch.cuda.synchronize()
    dev, host, window = events_of(prof)
    return Trace(units, window, dev, host, launches)


# ------------------------------------------------------------- reductions
def busy_seconds(events: List[Event], window: Tuple[float, float]) -> float:
    """Length of the union of the events' intervals inside the window."""
    spans = sorted((max(e.start, window[0]), min(e.end, window[1]))
                   for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(events: List[Event], window: Tuple[float, float]
              ) -> List[Tuple[float, float]]:
    """The intervals of the window that no event covers, longest first."""
    spans = sorted((e.start, e.end) for e in events)
    gaps, t = [], window[0]
    for s, e in spans:
        if s > t:
            gaps.append((t, min(s, window[1])))
        t = max(t, e)
    if t < window[1]:
        gaps.append((t, window[1]))
    return sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


def host_during(host: List[Event], t: float) -> str:
    """The innermost host operator running at ``t`` (the one that started
    last among those that cover it), or 'host idle'."""
    best = None
    for e in host:
        if e.start <= t <= e.end and (best is None or e.start > best.start):
            best = e
    return best.name if best else "no host operator"


def kernel_identifier(name: str) -> str:
    """A kernel's own function name from its demangled name: template
    arguments, parameters, return type and namespaces taken off."""
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


def per_name_seconds(events: List[Event], units: int) -> Dict[str, float]:
    """Device seconds over the traced units by event name, each name's mean
    duration times its records rounded up to a whole number a unit."""
    by: Dict[str, List[float]] = {}
    for e in events:
        by.setdefault(e.name, []).append(e.end - e.start)
    out = {}
    for name, ds in by.items():
        per_unit = max(1, round(len(ds) / units))
        out[name] = sum(ds) / len(ds) * max(len(ds), per_unit * units)
    return out


def port_kernel_names(csrc: Optional[Path] = None) -> frozenset:
    """The ``__global__`` functions of the measured program's CUDA sources."""
    if csrc is None:
        import audiossl_tpu_torch

        csrc = Path(audiossl_tpu_torch.__file__).parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    return frozenset(m.group(1) for f in sorted(csrc.glob("*.cu*"))
                     for m in pat.finditer(f.read_text()))


LIBRARY_GEMM = re.compile(r"gemm|gemv|cublas|cutlass|xmma|nvjet|cudnn|"
                          r"splitKreduce|sm\d\d_|dot_kernel|fmha|flash",
                          re.IGNORECASE)
COPIES = re.compile(r"Memcpy|Memset|copy|Copy|CatArray|\bcat_|transpose|"
                    r"permute|contiguous")
REDUCTIONS = re.compile(r"reduce|Reduce|[Ss]oft[Mm]ax|norm|Norm|[Ss]um|"
                        r"[Mm]ean|[Ss]can|[Ss]ort|topk|argmax")
ELEMENTWISE = re.compile(r"elementwise|vectorized|unrolled|pointwise",
                         re.IGNORECASE)
PORT = "port kernels"


def group_of(name: str, port_names) -> str:
    """tools/profile_step.py's groups: the port's own kernels by name, then
    library GEMMs, copies, aten reductions, aten elementwise, else the
    kernel's own name."""
    kind = kernel_identifier(name)
    if kind in port_names and "at::" not in name:
        return PORT
    for gname, pat, on in (("library GEMMs", LIBRARY_GEMM, name),
                           ("copies", COPIES, name),
                           ("aten reductions", REDUCTIONS, kind),
                           ("aten elementwise", ELEMENTWISE, kind)):
        if pat.search(on):
            return gname
    return kind


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    named by the host operator running in their middle (seconds over the
    traced units)."""
    by: Dict[str, float] = {}
    for k, v in per_name_seconds(tr.device, tr.units).items():
        ident = kernel_identifier(k)[:120]
        by[ident] = by.get(ident, 0.0) + v
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(host_during(tr.host, (a + b) / 2)[:120], b - a)
            for a, b in idle_gaps(tr.device, tr.window)[:top]]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
