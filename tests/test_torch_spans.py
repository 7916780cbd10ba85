"""The port's spans (``utils/spans.py``) on the CPU.

* With no profiler, ``span`` returns the one shared no-op and a frame step
  records nothing;
* under ``torch.profiler`` (CPU activity), a tiny frame step, a tiny
  clip finetuning step and a tiny ``get_scene_embedding`` call record
  exactly their spans, each with its parent, and every span after the
  profile's first starts and ends within 50 us of the profile's own range
  of that name (the two share the Unix-epoch clock);
* a two-step ``run_pretraining`` on a tiny pack records ``loader.wait``
  and ``checkpoint.save``.
"""
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiossl_tpu_torch import embedding as temb
from audiossl_tpu_torch.datasets import packed as tpacked
from audiossl_tpu_torch.downstream import finetune as tft
from audiossl_tpu_torch.methods.atstframe import method as tm
from audiossl_tpu_torch.models import atst as tatst
from audiossl_tpu_torch.training import runner
from audiossl_tpu_torch.training.pretrain import OptimizerConfig
from audiossl_tpu_torch.utils import spans

B = 2
STEP = [  # (name, parent) in the order the spans end
    ("step.input", "step"), ("step.forward", "step"),
    ("step.teacher", "step"), ("step.forward", "step"),
    ("step.backward", "step"), ("step.grad_sync", "step"),
    ("step.optimizer", "step"), ("step", None)]
FINETUNE_STEP = [
    ("step.input", "step"), ("step.forward", "step"),
    ("step.backward", "step"), ("step.grad_sync", "step"),
    ("step.optimizer", "step"), ("step", None)]
EMBED_CALL = [("embed.input", "embed.call"), ("embed.encoder", "embed.call"),
              ("embed.call", None)]
CLOCK_US = 50


@pytest.fixture(autouse=True)
def fresh():
    spans.clear()
    yield
    spans.clear()


def _frame():
    cfg = tm.FramePretrainConfig(
        arch="tiny", anchor_len=1.0,
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  max_steps=20))
    method = tm.FrameMethod(cfg, device="cpu", seed=0)
    return method.make_step(), method.init_state(0)


def _wav_batch(seed=5):
    rng = np.random.RandomState(seed)
    return {"wav": torch.from_numpy((rng.randn(B, 20000) * 0.1).astype(
        np.float32)), "valid": torch.tensor([20000, 13000])}


def _finetune():
    cfg = tft.FinetuneConfig(
        max_epochs=2, steps_per_epoch=1, warmup_steps=0, n_blocks=2,
        learning_rate=0.1, crop_len_s=1.5, chunk_len=61, multi_label=True,
        num_labels=5, mixup=True, specaug=True, rrc=True)
    task = tft.FinetuneTask(tatst.ast_tiny(spec_w=101, device="cpu"), cfg,
                            2 * 2 * 64)
    rng = np.random.RandomState(3)
    batch = {"wav": (rng.randn(B, 24000) * 0.1).astype(np.float32),
             "valid": np.asarray([24000, 9000], np.int32),
             "label": (rng.rand(B, 5) > 0.5).astype(np.float32)}
    rows = task.rows(B, 24000)
    draws = tft.draw_finetune(cfg, B, rows, task.encoder.depth,
                              torch.Generator().manual_seed(1),
                              np.random.default_rng(1))
    return task, task.init_state(), batch, draws


def _embed_model():
    torch.manual_seed(0)
    enc = tatst.frame_ast_tiny(spec_w=temb.CHUNK_FRAMES, device="cpu")
    return temb.EmbeddingModel(encoder=enc.eval(), n_blocks=2)


def _profiled(fn):
    """-> (spans recorded, the profile's own CPU ranges as (name, start ns,
    end ns)) of ``fn()`` under the profiler."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    recs = spans.records()
    names = {r.name for r in recs}
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    return recs, ranges


def _clock_gaps(recs, ranges):
    """Per span after the first, the larger of |start - the profile's
    start| and |end - its end| in ns, each span paired with the profile's
    range of its name in start order."""
    mine = sorted(recs, key=lambda r: r.start_ns)
    gaps = []
    for i, r in enumerate(mine[1:], 1):
        theirs = sorted((x for x in ranges if x[0] == r.name),
                        key=lambda x: x[1])
        _, start, end = theirs[[x.name for x in mine[:i]].count(r.name)]
        gaps.append(max(abs(r.start_ns - start), abs(r.end_ns - end)))
    return gaps


def _check(fn, want):
    """``fn()`` under the profiler records ``want`` (name, parent) in the
    order the spans end, with no device time, and every span after the
    first lies within ``CLOCK_US`` of the profile's range (the first may
    hold the profiler's own start-up). A loaded machine can stop the thread
    between a span's clock read and the profiler's, so three profiles are
    taken and each span is held to its closest of the three; one intra-op
    thread keeps the step's own threads from being among those that stop
    it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gaps = []
        for _ in range(3):
            recs, ranges = _profiled(fn)
            assert [(r.name, r.parent) for r in recs] == want
            assert all(r.device_ms is None and r.start_ns <= r.end_ns
                       for r in recs)
            gaps.append(_clock_gaps(recs, ranges))
    finally:
        torch.set_num_threads(threads)
    closest = [min(g) for g in zip(*gaps)]
    assert max(closest) <= CLOCK_US * 1e3, closest


def test_no_profiler_no_spans():
    assert spans.span("step") is spans.span("embed.call")
    step, state = _frame()
    step(state, _wav_batch())
    assert spans.records() == []


def test_frame_step_spans():
    step, state = _frame()
    batch = _wav_batch()
    step(state, batch)  # the first call's one-time work outside the profile
    _check(lambda: [step(state, batch) for _ in range(2)], STEP * 2)


def test_finetune_step_spans():
    task, state, batch, draws = _finetune()
    task.train_step(state, batch, draws)
    _check(lambda: [task.train_step(state, batch, draws) for _ in range(2)],
           FINETUNE_STEP * 2)


def test_scene_embedding_spans():
    model = _embed_model()
    audio = torch.from_numpy(
        (np.random.RandomState(4).randn(B, 16000) * 0.1).astype(np.float32))
    temb.get_scene_embedding(audio, model)
    _check(lambda: [temb.get_scene_embedding(audio, model)
                    for _ in range(2)], EMBED_CALL * 2)


def test_run_pretraining_records_loader_and_save(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tpacked.write_synthetic_pack(str(tmp_path / "pack"), "train", 6,
                                 min_s=0.5, max_s=1.5, seed=2)
    cfg = tm.FramePretrainConfig(
        arch="tiny", anchor_len=1.0,
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  max_steps=20))
    method = tm.FrameMethod(cfg, device="cpu", seed=0)
    data = tpacked.PackedAudioDataset(str(tmp_path / "pack"), "train")
    with profile(activities=[ProfilerActivity.CPU]):
        runner.run_pretraining(method, data, batch_size_per_device=B,
                               max_steps=2, save_path=str(tmp_path / "run"),
                               ckpt_interval=1, log_interval=1)
    names = [(r.name, r.parent) for r in spans.records()]
    assert names.count(("loader.wait", None)) == 2
    assert names.count(("checkpoint.save", None)) == 3  # steps 1, 2, final
    assert names.count(("step", None)) == 2


def test_loader_closed_at_the_last_step():
    """The loader's iterator is let go at the loop's ``break``, so its
    prefetch thread stops then, not when ``run_pretraining`` returns."""
    closed = []

    class Loader:
        def __iter__(self):
            try:
                yield from range(5)
            finally:
                closed.append(True)

    for batch in runner._waited(Loader()):
        if batch == 1:
            break
    assert closed == [True]


def test_profile_step_span_table():
    """``tools.profile_step``'s view of the spans: device ms a step by name
    (host ms with no device time) and each idle stretch, from the first
    span's start to the last one's end, put down to the innermost span the
    host was in at its middle."""
    from audiossl_tpu_torch.tools import profile_step as ps

    S = spans.Span
    recs = [S("step.input", "step", 100, 200, 0.5),
            S("step.forward", "step", 200, 400, 1.0),
            S("step", None, 90, 600, 2.0),
            S("step", None, 600, 700, None)]  # 100 ns on the host
    busy = [(0, 150), (170, 300), (320, 580), (650, 900)]
    idle = spans.idle_by_span(busy, recs)
    assert idle == {"step.input": 20, "step.forward": 20, "step": 70}
    table = ps.span_table(recs, 2, busy)
    assert table == {"step.input": [0.25, 1e-5], "step.forward": [0.5, 1e-5],
                     "step": [1.0 + 5e-5, 3.5e-5]}
    assert ps.span_table(recs, 1)["step"] == [2.0001, 0.0]
