"""The port's pretraining run loop and checkpoints on the CPU, against the
JAX package where it has the same part.

* ``CheckpointManager`` keeps the steps JAX's orbax manager keeps for one
  sequence of saves (interval 2, ``max_to_keep`` 3, a duplicate, forced
  saves), exactly;
* a frame-tiny state saved after two steps restores bit for bit (BatchNorm
  statistics, ``count``, ``step``, the generator's state) into the same
  tensors, and the next plain step from both states is bit-equal;
* a leftover ``.tmp`` is ignored, a failed background write raises at the
  next save;
* the batches ``run_pretraining`` hands the step equal, batch by batch
  over two epochs, JAX's ``BatchLoader`` and ``NativeBatchLoader`` on the
  same pack, seed, subset, pad and dtype (tolerance 0), int16 exactly when
  JAX picks it;
* resume, ``max_steps`` and the profiler trace; ``n_devices=2`` and
  ``shard_optimizer`` on 2 gloo ranks (``test_torch_ddp_runner.py``
  holds them further).

``torch.utils.tensorboard`` is kept from importing here (it loads
TensorFlow when that is installed): the logger is tested with a stand-in
``SummaryWriter``.
"""
import os
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audiossl_tpu.datasets import native as jnative
from audiossl_tpu.datasets import packed as jpacked
from audiossl_tpu.datasets import pipeline as jpipeline
from audiossl_tpu.training import checkpoint as jck
from audiossl_tpu_torch.datasets import packed as tpacked
from audiossl_tpu_torch.datasets import native as tnative
from audiossl_tpu_torch.methods.atstframe import method as tm
from audiossl_tpu_torch.training import checkpoint as tck
from audiossl_tpu_torch.training import runner
from audiossl_tpu_torch.training.pretrain import OptimizerConfig

B = 2


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _method(seed=0):
    cfg = tm.FramePretrainConfig(
        arch="tiny", anchor_len=1.0,
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                  max_steps=20))
    return tm.FrameMethod(cfg, device="cpu", seed=seed)


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    return {"wav": torch.from_numpy((rng.randn(B, 20000) * 0.1).astype(
        np.float32)), "valid": torch.tensor([20000, 13000])}


def _tensors(state):
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    out.update({f"mu.{k}": v for k, v in state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.nu.items()})
    out["generator"] = state.generator.get_state()
    return out


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pack"))
    tpacked.write_synthetic_pack(path, "train", 13, min_s=0.5, max_s=1.5,
                                 seed=2)
    return path


def test_checkpoint_manager_keeps_the_steps_orbax_keeps(tmp_path):
    state = _method().init_state(0)
    port = tck.CheckpointManager(str(tmp_path / "port"), 2, max_to_keep=3)
    ref = jck.CheckpointManager(str(tmp_path / "jax"), 2, max_to_keep=3)
    tree = {"a": np.zeros(3, np.float32)}
    seq = [(s, False) for s in (1, 2, 3, 4, 4, 5, 6, 7, 8, 9)] + [
        (9, True), (11, True), (10, True), (12, False), (13, True)]
    for step, force in seq:
        got = port.save(step, state, force=force)
        want = ref.save(step, tree, force=force)
        ref.wait()
        port.wait()
        assert got == want, (step, force)
        assert port.all_steps() == list(ref._mgr.all_steps()), step
        assert port.latest_step == ref.latest_step, step
    ref.close()
    port.close()
    assert sorted(int(n) for n in os.listdir(tmp_path / "port")) == [
        10, 12, 13]
    # reopened, both read the directory in step order
    port = tck.CheckpointManager(str(tmp_path / "port"), 2)
    ref = jck.CheckpointManager(str(tmp_path / "jax"), 2)
    assert port.all_steps() == list(ref._mgr.all_steps()) == [10, 12, 13]
    assert port.latest_step == ref.latest_step == 13
    for step in (14, 15, 16):
        assert port.save(step, state) == ref.save(step, tree)
        ref.wait()
    ref.close()
    port.close()


def test_restore_is_bit_equal_and_so_is_the_next_step(tmp_path):
    method = _method()
    state = method.init_state(7)
    step = method.make_step()
    batch = _batch()
    for _ in range(2):  # draws from the state's generator
        step(state, batch)
    mgr = tck.CheckpointManager(str(tmp_path), 1)
    assert mgr.save(state.step, state)
    mgr.wait()
    assert mgr.write_s[2] > 0 and mgr.last_copy_ms > 0

    other = _method(seed=3)
    restored = other.init_state(11)
    leaves = [p.data_ptr() for p in restored.leaves]
    moments = [v.data_ptr() for v in restored.mu.values()]
    assert tck.CheckpointManager(str(tmp_path), 1).restore_latest(
        restored) is restored
    assert restored.step == 2 and restored.count == 2
    assert [p.data_ptr() for p in restored.leaves] == leaves
    assert [v.data_ptr() for v in restored.mu.values()] == moments
    a, b = _tensors(state), _tensors(restored)
    assert a.keys() == b.keys()
    assert any("running_mean" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    la = float(step(state, batch)["loss"])
    lb = float(other.make_step()(restored, batch)["loss"])
    assert la == lb
    a, b = _tensors(state), _tensors(restored)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_restore_refuses_another_model(tmp_path):
    state = _method().init_state(0)
    mgr = tck.CheckpointManager(str(tmp_path), 1)
    mgr.save(1, state)
    mgr.wait()
    cfg = tm.FramePretrainConfig(arch="tiny", anchor_len=1.0, avg_blocks=1)
    d2v = tm.FrameMethod(cfg, device="cpu").init_state(0)
    with pytest.raises(KeyError):
        mgr.restore_latest(d2v)


def test_leftover_tmp_is_ignored_and_removed(tmp_path):
    state = _method().init_state(0)
    mgr = tck.CheckpointManager(str(tmp_path), 2)
    mgr.save(4, state)
    mgr.close()
    # a write cut by a crash: a half-written later step
    os.makedirs(tmp_path / "6.tmp")
    (tmp_path / "6.tmp" / "state.pt").write_bytes(b"truncated")
    os.makedirs(tmp_path / "8")  # a directory without its file
    mgr = tck.CheckpointManager(str(tmp_path), 2)
    assert mgr.latest_step == 4 and mgr.all_steps() == [4]
    assert not (tmp_path / "6.tmp").exists()
    restored = _method(seed=1).init_state(1)
    mgr.restore_latest(restored)
    assert restored.step == state.step


def test_failed_background_write_raises_at_the_next_save(tmp_path,
                                                         monkeypatch):
    state = _method().init_state(0)
    mgr = tck.CheckpointManager(str(tmp_path), 1, max_to_keep=1)
    assert mgr.save(1, state)
    mgr.wait()

    def full_disk(*a, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(tck.torch, "save", full_disk)
    assert mgr.save(2, state)  # the write fails in the background
    with pytest.raises(OSError, match="no space left"):
        mgr.save(3, state)
    monkeypatch.undo()
    # the failed step is not kept, the step it would have dropped is
    assert mgr.all_steps() == [1] and os.path.exists(tmp_path / "1")
    assert not os.path.exists(tmp_path / "2")
    assert mgr.save(3, state)
    mgr.close()
    assert mgr.all_steps() == [3]


class _Recorder:
    """A method whose step records the batches the run loop hands it."""

    def __init__(self, out_samples=16000):
        self.device = torch.device("cpu")
        self.cfg = SimpleNamespace(out_samples=out_samples)
        self.batches = []

    def init_state(self, seed):
        return SimpleNamespace(step=0)

    def make_step(self):
        def step(state, batch):
            self.batches.append(batch)
            state.step += 1
            return {"loss": torch.tensor(1.0)}
        return step


@pytest.mark.parametrize("native", [True, False])
def test_runner_batches_match_jax_loaders(pack, native, monkeypatch,
                                          capsys):
    """Two epochs of the batches the step receives, against JAX's
    BatchLoader and NativeBatchLoader as JAX's runner builds them; without
    the native reader (``native=False``) the Python loader gives the
    same."""
    if not native:
        def missing():
            raise RuntimeError("g++ not found")
        monkeypatch.setattr(tnative, "library", missing)
    ds = tpacked.PackedAudioDataset(pack, "train", subset=11)
    jds = jpacked.PackedAudioDataset(pack, "train", subset=11)
    assert jds.reader.all_int16()
    rec = _Recorder()
    runner.run_pretraining(rec, ds, batch_size_per_device=B,
                           max_steps=2 * (11 // B), seed=3, clip_len_s=1.2)
    out = capsys.readouterr().out
    assert ("loader: native" in out) == native
    assert native or "native reader unavailable: g++ not found" in out
    pad = 19200  # max(clip_len_s, the anchor) in samples
    for epoch in (0, 1):
        kw = dict(pad_samples=pad, shuffle=True, seed=3, epoch=epoch,
                  wav_dtype=np.int16)
        jax_py = list(jpipeline.BatchLoader(jds, B, include_labels=False,
                                            num_threads=2, **kw))
        jax_native = list(jnative.NativeBatchLoader(jds, B, **kw))
        got = rec.batches[epoch * 5:(epoch + 1) * 5]
        assert len(jax_py) == len(jax_native) == len(got) == 5
        for g, w, n in zip(got, jax_py, jax_native):
            assert g.keys() == w.keys() == n.keys() == {"wav", "valid"}
            for k in g:
                assert g[k].dtype == w[k].dtype == n[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
                np.testing.assert_array_equal(g[k], n[k])


def test_runner_emits_float32_where_jax_does(tmp_path):
    """A pack with a float32 record gives float32 batches, as JAX's
    all_int16 test decides; so does a dataset that is not a pack (through
    the Python loader)."""
    path = str(tmp_path)
    with tpacked.PackedWriter(f"{path}/train.ards") as w:
        for i in range(4):
            wav = np.random.RandomState(i).randn(9000) * 0.1
            w.add(wav.astype(np.float32 if i == 2 else np.int16), i)
    assert not jpacked.PackedReader(f"{path}/train.ards").all_int16()
    for ds in (tpacked.PackedAudioDataset(path),
               [(np.ones(100, np.float32), 0)] * 4):
        rec = _Recorder()
        runner.run_pretraining(rec, ds, batch_size_per_device=B,
                               max_steps=2)
        assert [b["wav"].dtype for b in rec.batches] == [np.float32] * 2
        assert rec.batches[0]["wav"].shape == (B, 160000)


def test_runner_resumes_and_stops_at_max_steps(tmp_path, capsys):
    save = str(tmp_path / "exp")
    kw = dict(batch_size_per_device=B, save_path=save, ckpt_interval=2,
              log_interval=1, seed=4)
    ds = [(np.random.RandomState(i).randn(20000).astype(np.float32) * 0.1,
           0) for i in range(5)]
    state = runner.run_pretraining(_method(), ds, max_steps=3, **kw)
    assert state.step == 3
    out = capsys.readouterr().out
    assert "step 3 " in out and "clips_per_sec=" in out
    assert "checkpoint step 2: host copy" in out
    assert sorted(os.listdir(os.path.join(save, "ckpt"))) == ["2", "3"]

    state = runner.run_pretraining(_method(seed=9), ds, max_steps=5, **kw)
    out = capsys.readouterr().out
    assert "resumed from step 3\n" in out
    assert "run ended at step 5: 2 steps taken" in out
    assert state.step == 5 and state.count == 5

    state = runner.run_pretraining(_method(), ds, max_steps=5, **kw)
    out = capsys.readouterr().out
    assert "resumed from step 5\n" in out
    assert "run ended at step 5: 0 steps taken" in out
    assert "checkpoint step" not in out and state.step == 5


def test_runner_writes_a_profile_trace_and_logs(tmp_path, monkeypatch):
    logged = []

    class SummaryWriter:
        def __init__(self, path):
            self.path = path

        def add_scalar(self, k, v, step):
            logged.append((k, step, v))

        def close(self):
            logged.append("closed")

    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = SummaryWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    monkeypatch.chdir(tmp_path)
    save = str(tmp_path / "exp")
    runner.run_pretraining(_Recorder(), [(np.zeros(50), 0)] * 4,
                           batch_size_per_device=B, max_steps=4,
                           save_path=None, log_interval=2, profile_at=1)
    assert os.listdir(tmp_path / "profile") == ["trace_step1.json"]
    assert logged == []  # no save_path: no TensorBoard
    runner.run_pretraining(_method(), [(np.zeros(20000), 0)] * 4,
                           batch_size_per_device=B, max_steps=2,
                           save_path=save, log_interval=1, profile_at=0)
    assert os.listdir(os.path.join(save, "profile")) == [
        "trace_step0.json"]
    assert ("loss", 1) in [e[:2] for e in logged[:-1]]
    assert ("clips_per_sec", 2) in [e[:2] for e in logged[:-1]]
    assert logged[-1] == "closed"


@pytest.mark.parametrize("kw", [dict(n_devices=2),
                                dict(shard_optimizer=True)])
def test_runner_refuses_more_than_one_device(kw, pack, tmp_path, capfd):
    """(Named when these options raised.) Each option runs on 2 gloo
    ranks: 3 steps with a checkpoint at step 2, both ranks end on the same
    state, only rank 0 prints and writes, and the checkpoint holds every
    parameter's moments; under ZeRO-1 each rank keeps about half of them.
    ``n_devices`` other than the group's size raises."""
    from test_torch_ddp_runner import spawn_run

    save = str(tmp_path / "exp")
    a, b = spawn_run(str(tmp_path / "out"), pack, save_path=save,
                     batch_size_per_device=B, max_steps=3, ckpt_interval=2,
                     log_interval=1, seed=4, clip_len_s=1.5, **kw)
    out = capfd.readouterr().out
    assert a["step"] == b["step"] == 3
    for k in a["tensors"]:
        assert torch.equal(a["tensors"][k], b["tensors"][k]), k
    assert out.count("run ended at step 3: 3 steps taken") == 1
    assert out.count("step 3 ") == 1 and "clips_per_sec=" in out
    assert sorted(os.listdir(os.path.join(save, "ckpt"))) == ["2", "3"]
    saved = torch.load(os.path.join(save, "ckpt", "3", "state.pt"),
                       weights_only=True)
    for k, v in saved["mu"].items():
        assert torch.equal(v, a["tensors"][f"mu.{k}"]), k
    full = sum(v.numel() * 4 for v in (*saved["mu"].values(),
                                       *saved["nu"].values()))
    if kw.get("shard_optimizer"):
        assert set(a["owned"]).isdisjoint(b["owned"])
        assert max(a["moment_bytes"], b["moment_bytes"]) < 0.6 * full
    else:
        assert a["moment_bytes"] == b["moment_bytes"] == full
    with pytest.raises(ValueError, match="n_devices=2"):
        runner.run_pretraining(_Recorder(), [], batch_size_per_device=B,
                               max_steps=1, n_devices=2)
