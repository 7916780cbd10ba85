"""Spans at the port's layer boundaries, recorded only while a torch
profiler runs.

``with span(name):`` opens a profiler range of that name (a host operator
of the profile, in every profile: the runner's ``--profile_at`` trace
too), and keeps a record of it: its name, the name of the span it opened
inside, ``time.time_ns()`` at its start and end (the Unix-epoch clock of
the profiler's own events), and, once CUDA is in use, a pair of timing
events recorded on the stream that was current when the outermost open
span opened. :func:`records` gives the finished spans with the device ms
between their events: the card's time from reaching the span's start to
reaching its end, idle stretches inside it included.

A span inside a profiled stretch costs the host as little as it can (on
the H100 under the profiler, in the benchmark's cells, 70–160 us a span),
because that time lands in the traced windows the per-layer metrics read:
the range is ``torch._C._profiler._RecordFunctionFast``, not
``torch.profiler.record_function`` (75–215 us a span less; a host operator
of the profile, not a user annotation, so a CUDA-only profile holds no
span); a span inside another records on the outer span's stream, not
looking it up again (~90 us less); and the timing events come from a
pool, made and recorded once at the first span a profile opens on a card
and given back as :func:`records` reads them (~0.15 ms less than making
them).

With no profiler running, ``span`` returns one shared no-op context and
records nothing; the profiler is the only switch. Spans are opened from
the thread that runs the step or call (the parent is the innermost span
open), and sit at the layer boundaries only, never per block, leaf or
kernel:

* ``step`` (a pretraining step, ``training/pretrain.py``; a finetuning
  step, ``downstream/finetune.py``) with ``step.input``, ``step.teacher``,
  ``step.forward`` (it may open twice a step), ``step.backward``,
  ``step.grad_sync`` and ``step.optimizer`` inside;
* ``embed.call`` (``embedding.py``) with ``embed.input`` and
  ``embed.encoder`` inside;
* ``loader.wait`` and ``checkpoint.save`` (``training/runner.py``).
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

CAPACITY = 65536  # records kept; the oldest go first
POOL = 128  # timing event pairs the pool makes at a time


class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the span it opened inside
    start_ns: int  # time.time_ns()
    end_ns: int
    device_ms: Optional[float]  # None where CUDA was not in use


_OFF = contextlib.nullcontext()
_open: list = []  # (name, stream or None) of the spans open, outermost first
# [name, parent, start_ns, end_ns, (start event, end event) | ms | None]
_done: collections.deque = collections.deque(maxlen=CAPACITY)
_free: list = []  # timing events made and recorded once, free for a span


def _pair(stream):
    """Two timing events of the pool, which makes ``POOL`` pairs when it
    runs dry (a CUDA event is made at its first record)."""
    if len(_free) < 2:
        for _ in range(2 * POOL):
            e = torch.cuda.Event(enable_timing=True)
            e.record(stream)
            _free.append(e)
    return _free.pop(), _free.pop()


class _Span:
    __slots__ = ("name", "parent", "range", "start_ns", "stream", "events")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent, self.stream = _open[-1] if _open else (None, None)
        if self.stream is None and torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
        _open.append((self.name, self.stream))
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.start_ns = time.time_ns()
        self.range.__enter__()
        self.events = None
        if self.stream is not None:
            self.events = _pair(self.stream)
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        self.range.__exit__(*exc)
        _open.pop()
        _done.append([self.name, self.parent, self.start_ns, time.time_ns(),
                      self.events])
        return False


def span(name: str):
    """A context that records ``name`` while a torch profiler runs, else
    the shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def records() -> List[Span]:
    """The finished spans in the order they ended, each span's device ms
    resolved from its events (waiting for them), which go back to the
    pool."""
    out = []
    for r in _done:
        if isinstance(r[4], tuple):
            start, end = r[4]
            end.synchronize()
            r[4] = start.elapsed_time(end)
            _free.extend((start, end))
        out.append(Span(*r))
    return out


def clear() -> None:
    """Forgets the finished spans; their events go back to the pool."""
    for r in _done:
        if isinstance(r[4], tuple):
            _free.extend(r[4])
    _done.clear()


def idle_by_span(busy: Sequence[Tuple[int, int]], recs: Sequence[Span]
                 ) -> Dict[Optional[str], int]:
    """Device idle ns by span name, from the first span's start to the last
    one's end: each stretch that none of the ``busy`` intervals (Unix ns of
    the kernels, copies and memsets) covers goes to the innermost span (of
    those whose host interval covers its midpoint, the one that started
    last), or to None."""
    lo = min(r.start_ns for r in recs)
    hi = max(r.end_ns for r in recs)
    gaps, t = [], lo
    for a, b in sorted(busy):
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    out: Dict[Optional[str], int] = collections.Counter()
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [r for r in recs if r.start_ns <= mid <= r.end_ns]
        out[max(inner, key=lambda r: r.start_ns).name if inner
            else None] += b - a
    return out

