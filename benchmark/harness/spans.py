"""What the measured program's own spans say of a traced run.

The program records a span at each of its layer boundaries while a torch
profiler runs (``audiossl_tpu_torch/utils/spans.py``): its name, the span
it opened inside, its host interval on ``time.time_ns()`` (the clock of the
profiler's events, so of ``Trace.window`` and ``Trace.device``) and the
card's ms between its start and end. A traced unit runs under the profiler
(``trace.profile_units``), so its spans are there to read; the timed
stretch runs none and records none.

Per traced stretch, only the spans whose host interval lies inside the
window count:

* a phase's device ms a unit: the sum of its span's device ms (a name may
  open twice a unit) over the units;
* the device's idle ms a unit inside a root span (``step``,
  ``embed.call``): each gap of ``trace.idle_gaps`` goes to the innermost
  span covering its midpoint (:func:`gaps_by_span`), and the gaps of the
  root's spans and its children's add up.

A program that records no span (one without the span module, or spawned
ranks the profiler does not reach) gives None: its metric is left out.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from harness import trace


def program_spans() -> list:
    """The program's finished spans, or [] where it records none."""
    try:
        from audiossl_tpu_torch.utils import spans
    except ImportError:
        return []
    return spans.records()


def in_window(recs, window) -> list:
    lo, hi = window[0] * 1e9, window[1] * 1e9
    return [r for r in recs if r.start_ns >= lo and r.end_ns <= hi]


def innermost(recs, t_ns: float):
    """The span covering ``t_ns`` that started last, or None."""
    best = None
    for r in recs:
        if r.start_ns <= t_ns <= r.end_ns and (
                best is None or r.start_ns > best.start_ns):
            best = r
    return best


def gaps_by_span(tr, recs) -> list:
    """[(seconds, span)] of each idle gap of the window, with the innermost
    span the host was in at its midpoint (None: in no span)."""
    recs = in_window(recs, tr.window)
    return [(b - a, innermost(recs, (a + b) / 2 * 1e9))
            for a, b in trace.idle_gaps(tr.device, tr.window)]


def unit_phase_ms(tr, recs, name: str) -> Optional[float]:
    """Device ms a unit of the spans named ``name`` in the window."""
    ms = [r.device_ms for r in in_window(recs, tr.window)
          if r.name == name and r.device_ms is not None]
    return sum(ms) / tr.units if ms else None


def unit_stall_ms(tr, recs, root: str) -> Optional[float]:
    """Device idle ms a unit put down to spans inside a ``root`` span of
    the window (the root's own and its children's)."""
    roots = [r for r in in_window(recs, tr.window) if r.name == root]
    if not roots:
        return None
    s = sum(g for g, r in gaps_by_span(tr, recs)
            if r is not None and innermost(roots, r.start_ns) is not None)
    return 1e3 * s / tr.units


def _mean_over_traces(out, fn: Callable) -> Optional[float]:
    recs: List = program_spans()
    vals = [fn(tr, recs) for tr in (out.traces or [])]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def phase_ms(out, name: str) -> Optional[float]:
    """Device ms a unit of the program's ``name`` spans."""
    return _mean_over_traces(out, lambda tr, recs: unit_phase_ms(tr, recs,
                                                                 name))


def host_stall_ms(out, root: str) -> Optional[float]:
    """Device idle ms a unit while the host was inside a ``root`` span."""
    return _mean_over_traces(out, lambda tr, recs: unit_stall_ms(tr, recs,
                                                                 root))
