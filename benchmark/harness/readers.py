"""What the per-layer metrics read from a traced run (``metrics/*.py`` are
one call each). A reader that finds nothing to read returns None, and the
harness leaves its metric out of the line. Device readings are averaged over
the chips a run traced."""
from __future__ import annotations

from typing import Callable, Optional

from harness import roofline, trace


def _mean_over_chips(out, fn: Callable) -> Optional[float]:
    vals = [fn(tr) for tr in (out.traces or [])]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def mfu_pct(out) -> Optional[float]:
    """Model FLOPs of a step or call over its time in the timed stretch
    before the profiler, over the peak of the configuration's products (of
    every chip the step runs on)."""
    if not (out.unit_s and out.unit_flops and out.peak_flops):
        return None
    return 100.0 * out.unit_flops / out.unit_s / out.peak_flops


def device_idle_pct(out) -> Optional[float]:
    """Share of the profiled window in which no kernel or copy ran."""
    def one(tr):
        if not tr.device:
            return None
        return 100.0 * (1.0 - trace.busy_seconds(tr.device, tr.window)
                        / tr.window_s)
    return _mean_over_chips(out, one)


def kernel_roofline_pct(out) -> Optional[float]:
    """The bounds of the program's own kernel launches in the profiled units
    over those kernels' device time."""
    names = trace.port_kernel_names()

    def one(tr):
        if not tr.launches:
            return None
        bound = roofline.launches_bound_s(tr.launches, out.bound_ctx)
        spent = sum(s for n, s in trace.per_name_seconds(tr.device, tr.units)
                    .items() if trace.group_of(n, names) == trace.PORT)
        if bound is None or spent <= 0:
            return None
        return 100.0 * bound / spent
    return _mean_over_chips(out, one)


def groups_ms(out, groups) -> Optional[float]:
    """Device ms a unit of the kernels in ``groups`` (profile_step's)."""
    names = trace.port_kernel_names()

    def one(tr):
        s = sum(v for n, v in trace.per_name_seconds(tr.device, tr.units)
                .items() if trace.group_of(n, names) in groups)
        return 1e3 * s / tr.units if s > 0 else None
    return _mean_over_chips(out, one)


def copies_ms(out, direction: str) -> Optional[float]:
    """Device ms a unit of the memory copies of ``direction`` (HtoD, DtoH)."""
    def one(tr):
        s = sum(e.end - e.start for e in tr.device
                if e.kind == "gpu_memcpy" and direction in e.name)
        return 1e3 * s / tr.units if s > 0 else None
    return _mean_over_chips(out, one)


def exposed_collective_ms(out) -> Optional[float]:
    """Device ms a unit in which a collective (NCCL) kernel runs and no
    other kernel or copy does: the union of all device work less the union
    of the work that is not a collective."""
    def one(tr):
        coll = [e for e in tr.device if "nccl" in e.name.lower()]
        if not coll:
            return None
        rest = [e for e in tr.device if "nccl" not in e.name.lower()]
        exposed = (trace.busy_seconds(tr.device, tr.window)
                   - trace.busy_seconds(rest, tr.window))
        return 1e3 * exposed / tr.units
    return _mean_over_chips(out, one)
