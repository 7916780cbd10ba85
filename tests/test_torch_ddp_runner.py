"""The data-parallel run loop, checkpoints, loaders, CLIs and dry run of the
port on 2 gloo ranks on the CPU.

* ``BatchLoader(process_index=, process_count=)``: the ranks' slices of
  each batch are contiguous, together the one-process batch, and equal to
  JAX's ``BatchLoader`` with the same arguments (tolerance 0); a batch
  that does not divide raises;
* ``run_pretraining`` at frame-tiny on a synthetic pack: a ZeRO-1 run on 2
  ranks (2 clips a rank) and a one-process run (4 clips) to step 2; rank
  0's checkpoint restored into a one-process state equals the one-process
  run's state (values and moments rel L2 1e-5, the step, Adam's count and
  the generator exactly), and runs resumed from either checkpoint, on 2
  ZeRO-1 ranks or in one process, reach the same state at step 3;
* ``--n_devices 2 --device cpu`` of the frame CLI for 2 steps;
* ``python -m audiossl_tpu_torch.parallel.dryrun --n_devices 2 --device
  cpu``.

The runs on ranks share one spawn; each spawn has a hard limit
(``parallel.launch.spawn``).
``torch.utils.tensorboard`` is kept from importing (it loads TensorFlow
when that is installed).
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audiossl_tpu_torch.datasets import packed as tpacked
from audiossl_tpu_torch.datasets.pipeline import BatchLoader
from audiossl_tpu_torch.methods.atstframe import method as tm
from audiossl_tpu_torch.parallel import launch
from audiossl_tpu_torch.parallel.mesh import world
from audiossl_tpu_torch.training import checkpoint as tck
from audiossl_tpu_torch.training import runner
from audiossl_tpu_torch.training.pretrain import OptimizerConfig

ROOT = Path(__file__).resolve().parents[1]
N_RANKS, PER_RANK = 2, 2
SPAWN_S = 180  # the hard limit of one spawn of ranks
LR = 1e-3
NOISE_LEAF = "encoder.norm_frame.bias"  # no gradient in exact arithmetic


def method(seed=0):
    cfg = tm.FramePretrainConfig(
        arch="tiny", anchor_len=1.0,
        optimizer=OptimizerConfig(learning_rate=LR, warmup_steps=1,
                                  max_steps=20))
    return tm.FrameMethod(cfg, device="cpu", seed=seed)


def state_tensors(state):
    """Every tensor of a state by name; the moments of every parameter
    (gathered from their owners under ZeRO-1: every rank calls this)."""
    saved = tck.host_state(state)
    out = {f"student.{k}": v for k, v in saved["student"].items()}
    out.update({f"teacher.{k}": v for k, v in saved["teacher"].items()})
    out.update({f"mu.{k}": v for k, v in saved["mu"].items()})
    out.update({f"nu.{k}": v for k, v in saved["nu"].items()})
    return out, saved


def run_on_ranks(workdir, pack, runs):
    """``run_pretraining`` of ``method()`` on this rank for each (name,
    kwargs) of ``runs`` in turn; every tensor of each final state, its
    moment bytes and step to ``<name>_rank<r>.pt``."""
    sys.modules["torch.utils.tensorboard"] = None
    for name, kw in runs:
        state = runner.run_pretraining(
            method(), tpacked.PackedAudioDataset(pack, "train"), **kw)
        tensors, saved = state_tensors(state)
        moment_bytes = sum(v.numel() * v.element_size() for v in
                           (*state.mu.values(), *state.nu.values()))
        torch.save(dict(tensors=tensors, step=state.step, count=state.count,
                        generator=saved["generator"],
                        moment_bytes=moment_bytes, owned=sorted(state.mu)),
                   os.path.join(workdir, f"{name}_rank{world().rank}.pt"))


def spawn_runs(workdir, pack, runs):
    """``run_on_ranks`` on 2 gloo ranks; each run's list of the ranks'
    results, by name."""
    os.makedirs(workdir, exist_ok=True)
    launch.spawn(run_on_ranks, N_RANKS, (workdir, pack, runs), device="cpu",
                 timeout_s=SPAWN_S)
    return {name: [torch.load(os.path.join(workdir, f"{name}_rank{r}.pt"),
                              weights_only=False) for r in range(N_RANKS)]
            for name, _ in runs}


def spawn_run(workdir, pack, **kw):
    """One ``run_pretraining`` with ``kw`` on 2 gloo ranks."""
    return spawn_runs(workdir, pack, [("run", kw)])["run"]


def _rel(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def assert_close_states(a, b, tol=1e-5, steps=3):
    """Two states' tensors (``state_tensors`` names): the student, the
    teacher and the moments each within rel L2 ``tol`` as a whole, and
    every tensor within 1e-3 (Adam's moments and steps magnify the
    rounding of gradients near zero). The final norm's bias has no
    gradient in exact arithmetic (the projector's BatchNorm cancels it):
    its moments hold rounding noise and are not compared, its values are
    held to lr a step on either path."""
    assert a.keys() == b.keys()
    for group in ("student.", "teacher.", "mu.", "nu."):
        keys = [k for k in a if k.startswith(group)
                and a[k].is_floating_point() and not k.endswith(NOISE_LEAF)]
        flat = [torch.cat([t[k].double().flatten() for k in keys])
                for t in (a, b)]
        assert _rel(*flat) < tol, group
        bad = [(k, _rel(a[k], b[k])) for k in keys if _rel(a[k], b[k]) > 1e-3]
        assert not bad, bad
    for branch in ("student.", "teacher."):
        k = branch + NOISE_LEAF
        assert float((a[k] - b[k]).abs().max()) <= 2 * LR * steps, k


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pack"))
    tpacked.write_synthetic_pack(path, "train", 13, min_s=0.5, max_s=1.5,
                                 seed=2)
    return path


@pytest.mark.parametrize("weights", [False, True])
def test_rank_loaders_split_the_global_batch_as_jax_does(pack, weights):
    jpipeline = pytest.importorskip("audiossl_tpu.datasets.pipeline")
    jpacked = pytest.importorskip("audiossl_tpu.datasets.packed")
    ds = tpacked.PackedAudioDataset(pack, "train")
    jds = jpacked.PackedAudioDataset(pack, "train")
    kw = dict(pad_samples=20000, shuffle=True, seed=5, epoch=1,
              wav_dtype=np.int16, num_threads=2)
    if weights:
        kw["weights"] = np.arange(1, len(ds) + 1, dtype=np.float64)
    whole = list(BatchLoader(ds, 4, **kw))
    for n in (2, 4):
        parts = [list(BatchLoader(ds, 4, process_index=r, process_count=n,
                                  **kw)) for r in range(n)]
        ref = [list(jpipeline.BatchLoader(jds, 4, process_index=r,
                                          process_count=n, **kw))
               for r in range(n)]
        for i, batch in enumerate(whole):
            for k in ("wav", "valid", "label"):
                got = [p[i][k] for p in parts]
                assert all(len(g) == 4 // n for g in got)
                np.testing.assert_array_equal(np.concatenate(got), batch[k])
                for g, r in zip(got, ref):
                    np.testing.assert_array_equal(g, r[i][k])
    with pytest.raises(ValueError, match="does not divide"):
        BatchLoader(ds, 3, pad_samples=100, process_index=0,
                    process_count=2)


@pytest.fixture(scope="module")
def runs(pack, tmp_path_factory):
    """A one-process run and a ZeRO-1 run on 2 ranks to step 2, and runs
    resumed from each checkpoint to step 3 (ZeRO-1 from the one-process
    one's, in the same spawn as the first ZeRO-1 run; one-process from
    the ZeRO-1 one's and from its own)."""
    root = tmp_path_factory.mktemp("runs")
    kw = dict(ckpt_interval=2, log_interval=1, seed=4, clip_len_s=1.5)
    single = runner.run_pretraining(
        method(), tpacked.PackedAudioDataset(pack, "train"), max_steps=2,
        save_path=str(root / "s"), batch_size_per_device=N_RANKS * PER_RANK,
        **kw)
    shutil.copytree(root / "s", root / "s_to_z")
    shutil.copytree(root / "s", root / "s_to_s")
    zero = dict(batch_size_per_device=PER_RANK, shard_optimizer=True, **kw)
    ranks = spawn_runs(str(root / "out"), pack, [
        ("zero", dict(save_path=str(root / "z"), max_steps=2, **zero)),
        ("s_to_z", dict(save_path=str(root / "s_to_z"), max_steps=3,
                        **zero))])
    shutil.copytree(root / "z", root / "z_to_s")
    resumed = {"s_to_z": ranks["s_to_z"]}
    for name in ("z_to_s", "s_to_s"):
        st = runner.run_pretraining(
            method(seed=9), tpacked.PackedAudioDataset(pack, "train"),
            save_path=str(root / name), max_steps=3,
            batch_size_per_device=N_RANKS * PER_RANK, **kw)
        resumed[name] = state_tensors(st)[0]
    return dict(root=root, zero=ranks["zero"], single=single,
                resumed=resumed)


def test_zero1_ranks_end_equal_with_their_moments_split(runs):
    a, b = runs["zero"]
    assert a["step"] == b["step"] == 2 and a["count"] == b["count"] == 2
    for k in a["tensors"]:
        assert torch.equal(a["tensors"][k], b["tensors"][k]), k
    assert torch.equal(a["generator"], b["generator"])
    assert set(a["owned"]).isdisjoint(b["owned"])
    n_leaves = sum(1 for k in a["tensors"] if k.startswith("mu."))
    assert len(a["owned"]) + len(b["owned"]) == n_leaves
    full = sum(v.numel() * v.element_size() for k, v in a["tensors"].items()
               if k.startswith(("mu.", "nu.")))
    assert a["moment_bytes"] + b["moment_bytes"] == full
    assert max(a["moment_bytes"], b["moment_bytes"]) < 0.6 * full


def test_zero1_checkpoint_restores_into_one_process(runs):
    """Rank 0's file, in the one-process layout, restored into a fresh
    one-process state: that of the one-process run on the same global
    batches."""
    ckpt = runs["root"] / "z" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["2"]
    restored = method(seed=9).init_state(0)
    assert tck.CheckpointManager(str(ckpt), 2).restore_latest(restored)
    single = runs["single"]
    assert restored.step == single.step == 2
    assert restored.count == single.count == 2
    assert torch.equal(restored.generator.get_state(),
                       single.generator.get_state())
    assert_close_states(state_tensors(restored)[0],
                        state_tensors(single)[0], steps=2)
    assert_close_states(runs["zero"][0]["tensors"],
                        state_tensors(single)[0], steps=2)


@pytest.mark.parametrize("name", ["z_to_s", "s_to_z"])
def test_resumed_runs_step_as_the_one_process_run(runs, name):
    """Resumed from the ZeRO-1 run's checkpoint in one process, or from
    the one-process run's on 2 ZeRO-1 ranks, a run reaches the state the
    one-process run reaches from its own."""
    want = runs["resumed"]["s_to_s"]
    got = runs["resumed"][name]
    if isinstance(got, list):
        assert all(r["step"] == 3 for r in got)
        got = got[0]["tensors"]
    assert_close_states(got, want)


def test_frame_cli_on_two_cpu_ranks(pack, tmp_path, capfd):
    from audiossl_tpu_torch.methods.atstframe import train as tframe

    save = str(tmp_path / "exp")
    out = tframe.main(["--data_path", pack, "--save_path", save,
                       "--device", "cpu", "--n_devices", "2",
                       "--batch_size_per_device", "2", "--warmup_steps",
                       "1", "--max_steps", "2", "--ckpt_interval", "2",
                       "--arch", "tiny", "--anchor_len", "1.0"])
    assert out is None  # the ranks ran in their own processes
    text = capfd.readouterr().out
    assert "loader: python BatchLoader (rank 0 of 2), 3 batches of 4" in text
    assert "run ended at step 2: 2 steps taken" in text
    assert text.count("run ended") == 1  # rank 0 prints
    assert sorted(os.listdir(os.path.join(save, "ckpt"))) == ["2"]
    state = method().init_state(0)
    saved = torch.load(os.path.join(save, "ckpt", "2", "state.pt"),
                       weights_only=True)
    assert set(saved["mu"]) == set(state.mu) and saved["step"] == 2


def test_dryrun_on_two_cpu_ranks():
    r = subprocess.run(
        [sys.executable, "-m", "audiossl_tpu_torch.parallel.dryrun",
         "--n_devices", "2", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=SPAWN_S)
    assert r.returncode == 0, r.stderr[-3000:]
    for i in (1, 2, 3, 4, 5):
        assert f"dryrun [{i}/5]" in r.stdout, r.stdout
    assert "2 rank(s)" in r.stdout
    assert "bit-equal to the replicated step's" in r.stdout
