"""The SED drivers (CPU).

* ``evaluate_val``, ``evaluate_test`` and ``evaluate_val_as_strong`` of
  the port and of the JAX package on the same stub predictions (a fixed
  function of each batch's waveform) and the same written tree: equal
  results (the PSDS and event F1 within 1e-12);
* ``python -m audiossl_tpu_torch.downstream.train_dcase ... --device cpu``
  and ``train_as_strong`` at tiny width on a written tree and a reference
  ``.ckpt``: ``result.json``, the keeper's index in "max" and "min" mode,
  AudioSet-strong's early stopping, and distill mode from the first runs'
  ``save_path``;
* ``TopKKeeper(mode="min")``, an index without a mode read as "max", and
  the distill teacher read from the keeper's best state by its mode;
* ``--arch beats`` (a comparison encoder) reads its checkpoint as the
  authors' BEATs file, so the ATST ``.ckpt`` raises for the key it lacks
  (``test_torch_comparison_adapters.py`` runs the comparison encoders
  through both drivers), and the default device raises here.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pd = pytest.importorskip("pandas")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.datasets import sed as jsed  # noqa: E402
from audiossl_tpu.downstream import train_as_strong as jas  # noqa: E402
from audiossl_tpu.downstream import train_dcase as jdcase  # noqa: E402
from audiossl_tpu.sed.module import SEDConfig as JSEDConfig  # noqa: E402
from audiossl_tpu_torch.datasets import sed  # noqa: E402
from audiossl_tpu_torch.downstream import train_as_strong as tas  # noqa: E402
from audiossl_tpu_torch.downstream import train_dcase as tdcase  # noqa: E402
from audiossl_tpu_torch.models.atst import frame_ast_tiny  # noqa: E402
from audiossl_tpu_torch.sed.module import SEDConfig  # noqa: E402
from audiossl_tpu_torch.training.checkpoint import (TopKKeeper,  # noqa: E402
                                                    read_topk_index)

ROOT = Path(__file__).resolve().parents[1]
AS_LABELS = ["/m/a", "/m/b", "/m/c", "/m/d", "/m/e"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """DCASE and AudioSet-strong trees of 2 s clips and a tiny frame
    encoder as a reference-layout ``.ckpt``."""
    root = tmp_path_factory.mktemp("sed_drivers")
    dcase, as_strong = str(root / "dcase"), str(root / "as_strong")
    sed.write_synthetic_sed(
        dcase, {"synth_train": 6, "weak_train": 10, "synth_val": 5,
                "strong_val": 6}, sed.DCASE_CLASSES,
        weak_splits=("weak_train",), duration_splits=("strong_val",),
        seed=3, seconds=2.0)
    sed.write_synthetic_sed(as_strong, {"train": 6, "val": 4, "eval": 5},
                            AS_LABELS, seed=4, seconds=2.0)
    enc = frame_ast_tiny(spec_w=1001, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    ckpt = str(root / "tiny.ckpt")
    torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                               for k, v in enc.state_dict().items()}}, ckpt)
    return root, dcase, as_strong, ckpt


def _stub(batch, C):
    """Scores [B, C, 250] and weak [B, C] as a fixed function of the
    waveform (JAX's evaluations drop the filenames before predicting)."""
    wav = np.asarray(batch["wav"])
    B = wav.shape[0]
    s = np.abs(wav).reshape(B, 250, -1).mean(-1)  # [B, 250]
    k = np.arange(1, C + 1)[None, :, None]
    strong = ((s[:, None, :] * 97.0 * k + 0.1 * k) % 1.0).astype(np.float32)
    return strong, strong.mean(-1)


def _predicts(C):
    def jpredict(state, batch):
        strong, weak = _stub(batch, C)
        return jnp.asarray(strong), jnp.asarray(weak)

    def predict(state, batch):
        strong, weak = _stub(batch, C)
        return torch.from_numpy(strong), torch.from_numpy(weak)
    return jpredict, predict


def _loaders(port_ds, jax_ds):
    return (sed.MixedBatchLoader([port_ds], [4], shuffle=False),
            jsed.MixedBatchLoader([jax_ds], [4], shuffle=False))


def test_evaluate_val_matches_jax(tree):
    _, dcase, _, _ = tree
    jpredict, predict = _predicts(10)
    port = sed.create_dcase(dcase, split="valid")
    ref = jsed.create_dcase(dcase, split="valid")
    got = tdcase.evaluate_val(None, predict, None,
                              *_loaders(port[0], ref[0])[:1],
                              _loaders(port[1], ref[1])[0], 7)
    want = jdcase.evaluate_val(None, jpredict, None,
                               _loaders(port[0], ref[0])[1],
                               _loaders(port[1], ref[1])[1], 7)
    assert got == want and 0 < got[0] < 1


@pytest.mark.parametrize("kind", ["dcase", "as_strong"])
def test_evaluate_test_matches_jax(tree, kind):
    _, dcase, as_strong, _ = tree
    if kind == "dcase":
        path, split, labels = dcase, "strong_val", sed.DCASE_CLASSES
        port = sed.create_dcase(dcase, split="test")
        ref = jsed.create_dcase(dcase, split="test")
    else:
        path, split, labels = as_strong, "eval", AS_LABELS
        enc = sed.dcase_encoder(labels=labels)
        port = sed.create_as_strong(as_strong, "test", encoder=enc)
        ref = jsed.create_as_strong(as_strong, "test",
                                    encoder=jsed.dcase_encoder(labels=labels))
    jpredict, predict = _predicts(len(labels))
    gt, durations = tdcase.read_ground_truth(os.path.join(path, split))
    jgt = pd.read_csv(os.path.join(path, split, "meta.tsv"), sep="\t")
    jdur = (pd.read_csv(os.path.join(path, split, "durations.tsv"), sep="\t")
            if kind == "dcase" else pd.DataFrame(
                {"filename": jgt.filename.unique(),
                 "duration": [10.0] * jgt.filename.nunique()}))
    assert list(durations["filename"]) == list(jdur.filename)
    record = {}
    got = tdcase.evaluate_test(None, predict, None, _loaders(port, ref)[0],
                               sed.dcase_encoder(labels=labels), SEDConfig(),
                               gt, durations, record)
    want = jdcase.evaluate_test(None, jpredict, None, _loaders(port, ref)[1],
                                jsed.dcase_encoder(labels=labels),
                                JSEDConfig(), jgt, jdur)
    assert set(got) == set(want) == {"psds1", "psds2", "event_f1"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert max(want.values()) > 0
    # the loader takes whole batches of 4 (JAX's MixedBatchLoader)
    assert record["decode_s"] > 0 and len(record["strong"]) == len(port) // 4


def test_evaluate_val_as_strong_matches_jax(tree):
    _, _, as_strong, _ = tree
    jpredict, predict = _predicts(len(AS_LABELS))
    enc = sed.dcase_encoder(labels=AS_LABELS)
    port = sed.create_as_strong(as_strong, "valid", encoder=enc)
    ref = jsed.create_as_strong(as_strong, "valid",
                                encoder=jsed.dcase_encoder(labels=AS_LABELS))
    got = tas.evaluate_val_as_strong(predict, None, _loaders(port, ref)[0], 7)
    want = jas.evaluate_val_as_strong(jpredict, None, _loaders(port, ref)[1],
                                      7)
    assert got == want and np.isfinite(got[0])


def _dcase_argv(tree, save, *extra):
    _, dcase, _, ckpt = tree
    return ["--pretrained_ckpt_path", ckpt, "--data_path", dcase,
            "--arch", "tiny", "--batch_size_synth", "2",
            "--batch_size_weak", "2", "--max_epochs", "2",
            "--warmup_epochs", "1", "--learning_rate", "0.01",
            "--save_path", save, "--device", "cpu", *extra]


def _as_argv(tree, save, *extra):
    _, _, as_strong, ckpt = tree
    return ["--pretrained_ckpt_path", ckpt, "--data_path", as_strong,
            "--arch", "tiny", "--batch_size", "3", "--max_epochs", "3",
            "--warmup_epochs", "1", "--save_path", save, "--device", "cpu",
            *extra]


def _result(save):
    with open(os.path.join(save, "result.json")) as f:
        res = json.load(f)
    assert set(res) == {"psds1", "psds2", "event_f1"}
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())
    return res


@pytest.fixture(scope="module")
def runs(tree):
    """The DCASE CLI as ``python -m`` and ``train_as_strong.main``, each
    at tiny width on the CPU."""
    root = tree[0]
    dcase_save, as_save = str(root / "dcase_out"), str(root / "as_out")
    r = subprocess.run(
        [sys.executable, "-m", "audiossl_tpu_torch.downstream.train_dcase",
         *_dcase_argv(tree, dcase_save)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    record = {}
    # every step in the warm-up from 0 to a learning rate of 0: no
    # parameter moves
    res = tas.main(_as_argv(tree, as_save, "--learning_rate", "0",
                            "--warmup_epochs", "3", "--patience", "1"),
                   record=record)
    return dcase_save, as_save, r.stdout, res, record


def test_dcase_cli_writes_result_and_keeps_max(runs):
    dcase_save, _, stdout, _, _ = runs
    res = _result(dcase_save)
    assert json.loads(stdout.strip().splitlines()[-1]) == res
    scores, mode = read_topk_index(os.path.join(dcase_save, "top",
                                                "index.json"))
    assert mode == "max" and sorted(scores) == [0, 1]
    assert "epoch 1: intersection_f1=" in stdout


def test_as_strong_keeps_min_and_stops_early(runs):
    _, as_save, _, res, record = runs
    assert _result(as_save) == res
    scores, mode = read_topk_index(os.path.join(as_save, "top", "index.json"))
    # no parameter moves: the validation loss never improves on epoch
    # 0's, so patience 1 stops the run after epoch 1
    assert mode == "min" and sorted(scores) == [0, 1]
    assert scores[0] == scores[1] and len(record["steps"]) == 2
    assert [n for n, _, _ in record["steps"][0]] == [3, 3]
    assert [n for n, _, _ in record["evals"][0]] == [32]
    assert all(0 < load < t for _, t, load in record["steps"][0])
    assert record["test"]["psds_s"] > 0


@pytest.mark.parametrize("kind", ["dcase", "as_strong"])
def test_distill_from_a_previous_run(tree, runs, kind):
    dcase_save, as_save, _, _, _ = runs
    save = str(tree[0] / f"{kind}_distill")
    if kind == "dcase":
        res = tdcase.main(_dcase_argv(tree, save, "--max_epochs", "1",
                                      "--distill_ckpt", dcase_save,
                                      "--distill_arch", "tiny"))
    else:
        res = tas.main(_as_argv(tree, save, "--max_epochs", "1",
                                "--distill_ckpt", as_save,
                                "--distill_arch", "tiny"))
    assert _result(save) == res


def test_keeper_modes(tmp_path):
    keeper = TopKKeeper(str(tmp_path / "a"), k=2, mode="min")
    for tag, m in enumerate([0.5, 0.2, 0.9, 0.1]):
        keeper.update(m, tag, {"w": torch.full((1,), float(tag))})
    assert keeper.best_tag == 3 and keeper.best_metric == 0.1
    assert float(keeper.restore_best()["w"]) == 3.0
    scores, mode = read_topk_index(os.path.join(keeper.dir, "index.json"))
    assert mode == "min" and scores == {1: 0.2, 3: 0.1}
    assert sorted(d for d in os.listdir(keeper.dir) if d.isdigit()) == \
        ["1", "3"]
    again = TopKKeeper(str(tmp_path / "a"), k=2, mode="min")
    assert not again.update(0.3, 4, {"w": torch.zeros(1)})
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"scores": {"2": 0.5, "7": 0.25}}))
    assert read_topk_index(str(legacy)) == ({2: 0.5, 7: 0.25}, "max")
    with pytest.raises(ValueError):
        TopKKeeper(str(tmp_path / "b"), mode="mean")


@pytest.mark.parametrize("mode", ["max", "min"])
def test_teacher_reads_the_best_by_mode(tree, tmp_path, mode):
    """Two kept states whose heads differ by their bias: the teacher's weak
    scores are the best one's."""
    _, _, _, ckpt = tree
    keeper = TopKKeeper(str(tmp_path), k=3, mode=mode)
    enc = frame_ast_tiny(spec_w=1001, device="cpu")
    for tag, metric in ((0, 0.4), (1, 0.6)):
        head = {"linear.weight": torch.zeros(3, 64),
                "linear.bias": torch.full((3,), float(tag) - 1.0),
                "linear_softmax.weight": torch.zeros(3, 64),
                "linear_softmax.bias": torch.zeros(3)}
        keeper.update(metric, tag, {"encoder": enc.state_dict(),
                                    "head": head})
    teacher = tdcase.build_sed_teacher(str(tmp_path), "tiny", ckpt, 3, "cpu")
    strong, weak = teacher(torch.zeros(1, 16000), torch.tensor([16000]))
    best = 1 if mode == "max" else 0
    np.testing.assert_allclose(weak.numpy(), torch.sigmoid(
        torch.full((1, 3), best - 1.0)).numpy(), rtol=1e-6)


@pytest.mark.parametrize("driver", ["train_dcase", "train_as_strong"])
def test_comparison_arch_and_default_device_raise(tree, driver):
    mod = tdcase if driver == "train_dcase" else tas
    argv = (_dcase_argv if driver == "train_dcase" else _as_argv)(
        tree, str(tree[0] / "unused"))
    arch = argv.index("--arch") + 1
    with pytest.raises(KeyError, match="patch_embedding.weight"):
        mod.main(argv[:arch] + ["beats"] + argv[arch + 1:])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv[:-2])
