"""The readers of the program's spans (``harness/spans.py``) on a synthetic
trace and synthetic spans: the window filter, the division by units, the
innermost span of each idle gap, the stall under a root, and None where
nothing was recorded."""
import collections
import json
import types

import pytest

from harness import spans as hs
from harness.trace import Event, Trace
import run

S = collections.namedtuple("S", "name parent start_ns end_ns device_ms")
NS = 10 ** 9
T0 = 1_700_000_000  # a Unix second


def ns(t):
    """Unix ns of ``t`` seconds after T0."""
    return T0 * NS + round(t * NS)


def kernel(a, b):
    return Event("kernel", "k", T0 + a, T0 + b)


# a window of 2 units (1 s to 9 s): the device busy 1-3, 4-6 and 6.5-9,
# idle 3-4 (1 s) and 6-6.5 (0.5 s)
TR = Trace(units=2, window=(T0 + 1.0, T0 + 9.0),
           device=[kernel(1, 3), kernel(4, 6), kernel(6.5, 9)], host=[],
           launches=[])
RECS = [
    S("step.input", "step", ns(1.1), ns(2.0), 10.0),
    S("step.forward", "step", ns(2.0), ns(3.8), 30.0),  # over gap 3-4
    S("step", None, ns(1.0), ns(5.0), 50.0),
    S("step.forward", "step", ns(5.0), ns(5.5), 7.0),
    S("step", None, ns(5.0), ns(9.0), 60.0),  # gap 6-6.5 in its own code
    S("step.forward", "step", ns(0.2), ns(0.9), 99.0),  # before the window
    S("step", None, ns(0.1), ns(0.95), 99.0),
    S("loader.wait", None, ns(8.5), ns(9.5), 1.0),  # past its end
]


def test_window_filter_and_units():
    assert hs.unit_phase_ms(TR, RECS, "step.forward") == (30.0 + 7.0) / 2
    assert hs.unit_phase_ms(TR, RECS, "step.input") == 5.0
    assert hs.unit_phase_ms(TR, RECS, "step") == 55.0
    assert hs.unit_phase_ms(TR, RECS, "loader.wait") is None
    assert hs.unit_phase_ms(TR, RECS, "step.teacher") is None


def test_gaps_go_to_the_innermost_span():
    got = sorted((round(g, 6), r.name if r else None, r and r.start_ns)
                 for g, r in hs.gaps_by_span(TR, RECS))
    assert got == [(0.5, "step", ns(5.0)), (1.0, "step.forward", ns(2.0))]
    # with no span over a gap's midpoint, the gap goes to none
    only = [r for r in RECS if r.name == "step.input"]
    assert [r for _, r in hs.gaps_by_span(TR, only)] == [None, None]


def test_stall_under_a_root():
    assert hs.unit_stall_ms(TR, RECS, "step") == pytest.approx(
        1e3 * 1.5 / 2)
    # the first step alone: its child's gap counts, the second's does not
    first = [r for r in RECS if r.end_ns <= ns(5.0)]
    assert hs.unit_stall_ms(TR, first, "step") == pytest.approx(1e3 / 2)
    assert hs.unit_stall_ms(TR, RECS, "embed.call") is None


def _out(*traces):
    return types.SimpleNamespace(traces=list(traces))


def test_readers_mean_over_traces_and_none_without_spans(monkeypatch):
    monkeypatch.setattr(hs, "program_spans", lambda: RECS)
    later = Trace(units=1, window=(T0 + 1.0, T0 + 5.0),
                  device=[kernel(1, 5)], host=[], launches=[])
    assert hs.phase_ms(_out(TR, later), "step.input") == (5.0 + 10.0) / 2
    assert hs.host_stall_ms(_out(TR, later), "step") == pytest.approx(
        (750.0 + 0.0) / 2)
    assert hs.phase_ms(_out(), "step.input") is None
    monkeypatch.setattr(hs, "program_spans", lambda: [])
    assert hs.phase_ms(_out(TR), "step.input") is None
    assert hs.host_stall_ms(_out(TR), "step") is None


def test_a_program_without_spans_reads_none(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_spans(name, *a, **kw):
        if name.startswith("audiossl_tpu_torch.utils"):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    assert hs.program_spans() == []


METRICS = ["input_ms.train", "teacher_ms.train", "forward_ms.train",
           "backward_ms.train", "optimizer_ms.train", "host_stall_ms.train",
           "input_ms.embed", "encoder_ms.embed", "host_stall_ms.embed"]


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_reads_its_span(name, monkeypatch):
    spec = {m["name"]: m for m in json.loads(
        (run.ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    assert spec[name]["source"] == "program_span"
    recs = [S(n, p, ns(a), ns(b), ms) for n, p, a, b, ms in [
        ("step", None, 1.0, 9.0, 80.0), ("step.input", "step", 1, 2, 1.0),
        ("step.teacher", "step", 2, 3, 2.0),
        ("step.forward", "step", 3, 4, 3.0),
        ("step.backward", "step", 4, 5, 4.0),
        ("step.optimizer", "step", 5, 6, 5.0),
        ("embed.call", None, 1.0, 9.0, 80.0),
        ("embed.input", "embed.call", 1, 2, 6.0),
        ("embed.encoder", "embed.call", 2, 6, 7.0)]]
    monkeypatch.setattr(hs, "program_spans", lambda: recs)
    reader = run.load_module(run.BENCH / "metrics" / f"{name}.py",
                             "metric_" + name.replace(".", "_"))
    want = {"input_ms.train": 0.5, "teacher_ms.train": 1.0,
            "forward_ms.train": 1.5, "backward_ms.train": 2.0,
            "optimizer_ms.train": 2.5, "host_stall_ms.train": 750.0,
            "input_ms.embed": 3.0, "encoder_ms.embed": 3.5,
            "host_stall_ms.embed": 750.0}[name]
    assert reader.read(_out(TR)) == pytest.approx(want)
    monkeypatch.setattr(hs, "program_spans", lambda: [])
    assert reader.read(_out(TR)) is None
