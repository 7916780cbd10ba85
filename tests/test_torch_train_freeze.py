"""The probe slice as a whole, and its data layer, against the JAX package
(CPU).

* ``write_synthetic_pack``: the port's files equal JAX's byte for byte;
  ``BatchLoader`` yields JAX's batches on the same pack (shuffled or not,
  a ragged last batch, float32 and int16), and an unreadable record
  fails the iteration instead of shortening the split;
* ``TopKKeeper`` keeps the 10 best heads on disk and in ``index.json``,
  across a reopen;
* ``tasks.py`` (the ``csv`` module) gives the pandas reader's files and
  labels on a small CSV and wav tree written here;
* ``train_freeze.main(..., "--device", "cpu")`` on a synthetic
  ``audioset_b`` pack (clips of 1-8 s, 8 s crops) with a tiny clip and a
  tiny frame encoder from one reference-layout ``.ckpt``: each split's
  cached embeddings against what JAX's ``main`` extracts from the same
  file (atol 2e-4), and the same ``result.json`` keys; the clip crops of
  801 frames make two chunks of 601, the first passed unclamped, the frame
  encoder's 2 s chunks (201 frames) make three, the 198-frame tail
  dropped;
* ``train_freeze_config.main`` on a YAML file gives ``main``'s result;
* a tone task at tiny width (as ``tests/test_e2e_probe.py``): the port's
  probe on a random frozen encoder learns it well above chance.
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from audiossl_tpu import datasets as jds  # noqa: E402
from audiossl_tpu.datasets import tasks as jtasks  # noqa: E402
from audiossl_tpu.downstream import train_freeze as jtf  # noqa: E402
from audiossl_tpu_torch import datasets as tds  # noqa: E402
from audiossl_tpu_torch.datasets import tasks as ttasks  # noqa: E402
from audiossl_tpu_torch.downstream import train_freeze as ttf  # noqa: E402
from audiossl_tpu_torch.downstream import train_freeze_config as ttfc  # noqa: E402
from audiossl_tpu_torch.downstream.embedding import (  # noqa: E402
    extract_split,
    make_clip_extractor,
)
from audiossl_tpu_torch.downstream.linear import (  # noqa: E402
    LinearProbeConfig,
    train_linear_probe,
)
from audiossl_tpu_torch.models.atst import (  # noqa: E402
    AudioTransformer,
    ast_tiny,
    frame_ast_tiny,
)
from audiossl_tpu_torch.models.heads import LinearHead  # noqa: E402
from audiossl_tpu_torch.training.checkpoint import (  # noqa: E402
    TOP_K,
    TopKKeeper,
    read_topk_index,
)

SPLITS = (("train", 16, 1), ("valid", 8, 2), ("test", 8, 3))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind, multi", [("noise", False), ("tones", True)])
def test_synthetic_pack_bytes_match_jax(tmp_path, kind, multi):
    kw = dict(min_s=0.2, max_s=0.6, num_labels=527 if multi else 10,
              multi_label=multi, seed=4, kind=kind)
    jds.write_synthetic_pack(str(tmp_path / "jax"), "train", 7, **kw)
    tds.write_synthetic_pack(str(tmp_path / "port"), "train", 7, **kw)
    for name in ("train.ards", "train.ards.idx"):
        assert _read(tmp_path / "port" / name) == _read(
            tmp_path / "jax" / name)


@pytest.mark.parametrize("shuffle, wav_dtype",
                         [(False, np.float32), (True, np.int16)])
def test_batch_loader_matches_jax(tmp_path, shuffle, wav_dtype):
    path = str(tmp_path / "data")
    tds.write_synthetic_pack(path, "valid", 11, min_s=0.2, max_s=0.5,
                             num_labels=527, multi_label=True, seed=5)
    kw = dict(batch_size=4, pad_samples=6000, shuffle=shuffle,
              drop_last=False, seed=3, wav_dtype=wav_dtype)
    want = list(jds.BatchLoader(jds.PackedAudioDataset(path, "valid"), **kw))
    got = list(tds.BatchLoader(tds.PackedAudioDataset(path, "valid"), **kw))
    assert [len(b["valid"]) for b in got] == [4, 4, 3]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


class _Corrupt:
    """A pack whose record ``bad`` cannot be read."""

    def __init__(self, ds, bad):
        self.ds, self.bad = ds, bad

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError(f"record {i} is unreadable")
        return self.ds[i]


@pytest.mark.parametrize("bad", [0, 5, 10])
def test_batch_loader_raises_on_an_unreadable_record(tmp_path, bad):
    """A record that fails to load fails the iteration: the split never
    ends early with fewer batches."""
    path = str(tmp_path / "data")
    tds.write_synthetic_pack(path, "valid", 11, min_s=0.2, max_s=0.5,
                             seed=5)
    loader = tds.BatchLoader(_Corrupt(tds.PackedAudioDataset(path, "valid"),
                                      bad),
                             batch_size=4, pad_samples=6000, shuffle=False,
                             drop_last=False)
    got = []
    with pytest.raises(OSError, match=f"record {bad} is unreadable"):
        for b in loader:
            got.append(b)
    assert len(got) == bad // 4


def test_topk_keeper_keeps_the_best_ten(tmp_path):
    """13 epochs in: the 10 highest metrics stay, on disk and in
    ``index.json``; a keeper reopened on the directory goes on from it."""
    metrics = np.random.RandomState(7).rand(13).tolist()
    keeper = TopKKeeper(str(tmp_path))
    for epoch, m in enumerate(metrics[:12]):
        keeper.update(m, epoch, {"w": torch.full((2,), float(epoch))})
    keeper = TopKKeeper(str(tmp_path))
    saved = keeper.update(metrics[12], 12, {"w": torch.full((2,), 12.0)})
    want = sorted(range(13), key=metrics.__getitem__)[-TOP_K:]
    assert saved == (12 in want)
    top = tmp_path / "top"
    scores, mode = read_topk_index(str(top / "index.json"))
    assert mode == "max"
    assert sorted(scores) == sorted(want)
    assert all(scores[t] == metrics[t] for t in want)
    assert sorted(int(d) for d in os.listdir(top) if d.isdigit()) == \
        sorted(want)
    for t in want:
        state = torch.load(top / str(t) / "state.pt", weights_only=True)
        assert torch.equal(state["w"], torch.full((2,), float(t)))


def _wav_tree(root):
    """Nsynth and US8K csv metadata over short wav files."""
    rng = np.random.RandomState(6)
    meta = os.path.join(root, "metadata")
    os.makedirs(meta)
    rows = {"nsynth": [], "us8k": []}
    labels = ["guitar", "bass", "flute", "bass", "organ", "guitar"]
    for i, lab in enumerate(labels):
        for task in rows:
            rel = (f"audio/{task}_{i}.wav" if task == "nsynth"
                   else f"audio/fold{i % 3 + 1}/{task}_{i}.wav")
            os.makedirs(os.path.dirname(os.path.join(root, rel)),
                        exist_ok=True)
            wavfile.write(os.path.join(root, rel), 16000,
                          (rng.randn(400) * 3000).astype(np.int16))
            split = ("train", "valid", "test")[i % 3]
            rows[task].append(f"{rel},{lab},{split}")
    for task, lines in rows.items():
        with open(os.path.join(meta, f"{task}.csv"), "w") as f:
            f.write("file_name,label,split\n" + "\n".join(lines) + "\n")
    return meta


def test_tasks_match_pandas_reader(tmp_path):
    root = str(tmp_path)
    meta = _wav_tree(root)
    cases = [("Nsynth", dict(split=s)) for s in ("train", "val", "test")]
    cases += [("Urbansound8k", dict(split=s, fold=f))
              for s in ("train", "test") for f in (0, 2)]
    for cls, kw in cases:
        want = getattr(jtasks, cls)(root, meta, **kw)
        got = getattr(ttasks, cls)(root, meta, **kw)
        assert got.files == want.files and len(got.files) > 0, (cls, kw)
        assert got.labels == want.labels, (cls, kw)
        np.testing.assert_array_equal(got[0][0], want[0][0])


def _pack_and_ckpts(tmp_path):
    """A synthetic audioset_b pack (clips of 1-8 s) and one reference-layout
    .ckpt per encoder type, seeded."""
    data = str(tmp_path / "data")
    for split, n, seed in SPLITS:
        tds.write_synthetic_pack(data, split, n, min_s=1.0, max_s=8.0,
                                 num_labels=527, multi_label=True,
                                 seed=seed, kind="tones")
    ckpts = {}
    for kind, maker, spec_w in (("clip", ast_tiny, 1001),
                                ("frame", frame_ast_tiny, 201)):
        enc = maker(spec_w=spec_w, device="cpu",
                    generator=torch.Generator().manual_seed(8))
        path = str(tmp_path / f"{kind}.ckpt")
        torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                                   for k, v in enc.state_dict().items()}},
                   path)
        ckpts[kind] = path
    return data, ckpts


@pytest.fixture(scope="module")
def probe_data(tmp_path_factory):
    return _pack_and_ckpts(tmp_path_factory.mktemp("probe"))


def _argv(data, ckpt, kind, save):
    argv = ["--pretrained_ckpt_path", ckpt, "--data_path", data,
            "--dataset_name", "audioset_b", "--model_type", kind,
            "--arch", "tiny", "--batch_size", "8", "--max_epochs", "3",
            "--n_last_blocks", "2", "--train_len", "8.0",
            "--save_path", save]
    return argv + (["--chunk_len_s", "2.0"] if kind == "frame" else [])


@pytest.mark.parametrize("kind", ["clip", "frame"])
def test_main_matches_jax(kind, probe_data, tmp_path, monkeypatch):
    data, ckpts = probe_data
    seen = []

    def capture(fn, loader):
        out = extract(fn, loader)
        seen.append(out)
        return out

    extract = jtf.extract_split
    monkeypatch.setattr(jtf, "extract_split", capture)
    jtf.main(_argv(data, ckpts[kind], kind, str(tmp_path / "jax")))
    record = {}
    res = ttf.main(_argv(data, ckpts[kind], kind, str(tmp_path / "port"))
                   + ["--device", "cpu"], record=record)
    cache = record[0]["embeddings"]
    for (split, n, _), (want_e, want_y) in zip(SPLITS, seen):
        got_e, got_y = cache[split]
        dim = (4 if kind == "clip" else 2) * 64
        assert got_e.shape == want_e.shape == (n, dim), split
        np.testing.assert_allclose(got_e, want_e, atol=2e-4)
        np.testing.assert_array_equal(got_y, want_y)
    files = [json.load(open(tmp_path / who / "result.json"))
             for who in ("jax", "port")]
    assert files[1] == res and files[1].keys() == files[0].keys()
    assert res["metric"] == "mAP" and res["folds"] == 1
    assert all(0.0 <= res[k] <= 1.0 for k in ("val", "test"))
    top = tmp_path / "port" / "fold0" / "top"
    scores, mode = read_topk_index(str(top / "index.json"))
    assert mode == "max" and len(scores) == 3
    best_tag = max(scores, key=scores.__getitem__)
    assert scores[best_tag] == res["val"]
    best = torch.load(top / str(best_tag) / "state.pt", weights_only=True)
    assert set(best) == set(LinearHead(best["linear.weight"].shape[1],
                                       527).state_dict())
    assert [n for n, _ in record[0]["timings"]["train"]] == [8, 8]


@pytest.mark.parametrize("kind", ["clip", "frame"])
def test_config_driver_matches_main(kind, probe_data, tmp_path):
    yaml = pytest.importorskip("yaml")
    data, ckpts = probe_data
    argv = _argv(data, ckpts[kind], kind, str(tmp_path / "flags"))
    want = ttf.main(argv + ["--device", "cpu"])
    cfg = {"data": {"dataset_name": "audioset_b", "data_path": data},
           "model": {"pretrained_ckpt_path": ckpts[kind], "model_type": kind,
                     "arch": "tiny", "n_last_blocks": 2},
           "train": {"batch_size": 8, "max_epochs": 1, "train_len": 8.0,
                     "save_path": str(tmp_path / "cfg"), "device": "cpu"}}
    if kind == "frame":
        cfg["model"]["chunk_len_s"] = 2.0
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    got = ttfc.main([str(path), "train.max_epochs=3"])
    assert got == want
    assert ttfc.main(["--help"]) is None


def test_device_cuda_raises_without_a_card(probe_data, monkeypatch):
    data, ckpts = probe_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.main(_argv(data, ckpts["clip"], "clip", "unused"))


def _tones(n, seed):
    """class c -> a tone at (c + 1) * 500 Hz and noise, 1 s."""
    rng = np.random.RandomState(seed)
    t = np.arange(16000) / 16000.0
    X, y = [], []
    for _ in range(n):
        c = rng.randint(4)
        f = (c + 1) * 500 + rng.uniform(-30, 30)
        wav = 0.3 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28))
        X.append((wav + rng.randn(len(t)) * 0.05).astype(np.float32))
        y.append(c)
    return np.stack(X), np.asarray(y)


class _Loader:
    def __init__(self, X, y, bs=32):
        self.X, self.y, self.bs = X, y, bs

    def __iter__(self):
        for i in range(0, len(self.X), self.bs):
            xb = self.X[i: i + self.bs]
            yield {"wav": xb,
                   "valid": np.full(len(xb), xb.shape[1], np.int32),
                   "label": self.y[i: i + self.bs]}


def test_probe_separates_tones():
    enc = AudioTransformer(embed_dim=32, depth=2, num_heads=2, spec_w=101,
                           use_cls=True, device="cpu").eval()
    extract = make_clip_extractor(enc, crop_len_s=1.0, n_blocks=2,
                                  chunk_len=101)
    etr, ltr = extract_split(extract, _Loader(*_tones(160, 0)))
    ete, lte = extract_split(extract, _Loader(*_tones(64, 1)))
    cfg = LinearProbeConfig(learning_rate=0.05, batch_size=64, max_epochs=30,
                            num_labels=4)
    res = train_linear_probe(etr, ltr, ete[:32], lte[:32], ete[32:],
                             lte[32:], cfg, device="cpu")
    assert res["val_metric"] > 0.75  # chance = 0.25
    assert res["test_metric"] > 0.75
