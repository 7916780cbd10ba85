"""Evaluating the port's own pretraining checkpoints (CPU).

The frame CLI (``--arch tiny``, 10 s anchors, 2 steps) and the clip CLI
(``--arch tiny``, 1 s crops, 1 step) write ``<save>/ckpt/<step>/state.pt``;
``embedding.load_model`` and ``train_freeze.load_encoder`` take that file
or its step directory. The encoder they load is, tensor for tensor, the
saved branch's ``encoder.`` entries, in the port's layout as saved (not
through the reference mapping), with the arch inferred from the width and
block count (``compat.checkpoint.infer_arch``); a clip checkpoint loads
into the clip encoder at its own position count. A shape no arch has, a
state that is not a pretraining checkpoint, an arch or type other than
the file's, and a directory without ``state.pt`` (orbax's) raise. The
linear probe runs end to end on a step directory.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from audiossl_tpu_torch import datasets as tds
from audiossl_tpu_torch.compat import checkpoint as ck
from audiossl_tpu_torch.downstream import train_freeze
from audiossl_tpu_torch.embedding import (get_scene_embedding,
                                          get_timestamp_embedding, load_model)
from audiossl_tpu_torch.methods.atst import train as clip_cli
from audiossl_tpu_torch.methods.atstframe import train as frame_cli
from audiossl_tpu_torch.models import atst as tatst


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """A pack, the frame CLI's step-2 and the clip CLI's step-1
    checkpoints."""
    root = tmp_path_factory.mktemp("pretrain_eval")
    data = str(root / "data")
    for split, n, seed in (("train", 8, 1), ("valid", 6, 2),
                           ("test", 6, 3)):
        tds.write_synthetic_pack(data, split, n, min_s=0.5, max_s=1.5,
                                 num_labels=527, multi_label=True,
                                 seed=seed, kind="tones")
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        frame_cli.main(["--data_path", data, "--save_path",
                        str(root / "frame"), "--arch", "tiny",
                        "--anchor_len", "10.0", "--batch_size_per_device",
                        "2", "--max_steps", "2", "--ckpt_interval", "2",
                        "--device", "cpu"])
        clip_cli.main(["--data_path", data, "--save_path", str(root / "clip"),
                       "--arch", "tiny", "--anchor_len", "1.0", "1.0",
                       "--positive_len", "1.0", "1.0",
                       "--batch_size_per_device", "2", "--max_steps", "1",
                       "--ckpt_interval", "1", "--device", "cpu"])
    finally:
        mp.undo()
    return dict(root=root, data=data,
                frame=str(root / "frame" / "ckpt" / "2"),
                clip=str(root / "clip" / "ckpt" / "1"))


def _saved(step_dir, which="teacher"):
    saved = torch.load(os.path.join(step_dir, "state.pt"), weights_only=True)
    return {k[len("encoder."):]: v for k, v in saved[which].items()
            if k.startswith("encoder.")}


def _assert_same(enc, want):
    got = enc.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


@pytest.mark.parametrize("which", ["teacher", "student"])
@pytest.mark.parametrize("form", ["file", "step_dir"])
def test_load_model_takes_the_frame_cli_state(saves, form, which):
    path = saves["frame"] if form == "step_dir" else os.path.join(
        saves["frame"], "state.pt")
    model = load_model(path, which=which, device="cpu")
    assert (model.encoder.embed_dim, model.encoder.depth) == (64, 2)
    _assert_same(model.encoder, _saved(saves["frame"], which))
    if which == "teacher":  # the student differs after two steps
        assert any(not torch.equal(v, _saved(saves["frame"], "student")[k])
                   for k, v in _saved(saves["frame"]).items())
    wav = torch.from_numpy(np.random.RandomState(0).randn(2, 24000)
                           .astype(np.float32) * 0.1)
    scene = get_scene_embedding(wav, model)
    assert scene.shape == (2, 2 * 64) and bool(torch.isfinite(scene).all())
    emb, ts = get_timestamp_embedding(wav, model)
    assert emb.shape[0] == 2 and bool(torch.isfinite(emb).all())


@pytest.mark.parametrize("form", ["file", "step_dir"])
def test_load_encoder_takes_the_frame_cli_state(saves, form):
    path = saves["frame"] if form == "step_dir" else os.path.join(
        saves["frame"], "state.pt")
    # a probe's 2 s chunks: the encoder keeps the checkpoint's 250
    # positions, which cover them
    enc = train_freeze.load_encoder(path, "frame", "tiny", spec_w=201,
                                    device="cpu")
    assert enc.pos_embed.shape == (1, 251, 64) and not enc.training
    _assert_same(enc, _saved(saves["frame"]))


def test_load_encoder_takes_the_clip_cli_state(saves):
    enc = train_freeze.load_encoder(saves["clip"], "clip", "tiny",
                                    device="cpu")
    assert enc.use_cls and enc.pos_embed.shape == (1, 26, 64)
    _assert_same(enc, _saved(saves["clip"]))
    emb = enc.get_intermediate_layers_chunks(
        torch.randn(2, 64, 101), torch.tensor([101, 60]), n=2, chunk_len=101)
    assert emb.shape == (2, 2 * 2 * 64) and bool(torch.isfinite(emb).all())


@pytest.mark.parametrize("model_type, arch", [("clip", "tiny"),
                                              ("frame", "small")])
def test_another_arch_than_the_files_raises(saves, model_type, arch):
    with pytest.raises(ValueError, match="frame tiny encoder"):
        train_freeze.load_encoder(saves["frame"], model_type, arch,
                                  device="cpu")


def test_load_model_refuses_a_clip_state(saves):
    with pytest.raises(ValueError, match="clip tiny"):
        load_model(saves["clip"], device="cpu")


def test_load_model_refuses_positions_shorter_than_its_chunks(saves, tmp_path):
    """Serving's 1001-frame chunks need the 250 positions of 10 s
    anchors; a frame checkpoint of 1 s anchors holds 25."""
    enc = tatst.frame_ast_tiny(spec_w=101, device="cpu")
    step = tmp_path / "1"
    step.mkdir()
    torch.save({"teacher": {f"encoder.{k}": v for k, v in
                            enc.state_dict().items()}}, step / "state.pt")
    with pytest.raises(ValueError, match="25 position embeddings"):
        load_model(str(step), device="cpu")
    assert train_freeze.load_encoder(str(step), "frame", "tiny",
                                     device="cpu").pos_embed.shape[1] == 26


@pytest.mark.parametrize("maker", ["ast_tiny", "ast_small", "ast_base",
                                   "frame_ast_tiny", "frame_ast_small",
                                   "frame_ast_base"])
def test_infer_arch_reads_the_tier_off_the_shapes(maker):
    enc = getattr(tatst, maker)(device="meta")
    kind, arch = ck.infer_arch(enc.state_dict())
    assert kind == ("clip" if maker.startswith("ast") else "frame")
    assert maker.endswith(arch)


def test_a_shape_no_arch_has_raises(tmp_path):
    """The dry run's encoder: width 128, 3 blocks."""
    enc = tatst.AudioTransformer(embed_dim=128, depth=3, num_heads=4,
                                 device="cpu")
    step = tmp_path / "3"
    step.mkdir()
    torch.save({"step": 3, "teacher": {f"encoder.{k}": v for k, v in
                                       enc.state_dict().items()}},
               step / "state.pt")
    with pytest.raises(ValueError, match="width 128 and 3 blocks"):
        load_model(str(step), device="cpu")
    with pytest.raises(ValueError, match="no arch"):
        train_freeze.load_encoder(str(step / "state.pt"), "frame", "tiny",
                                  device="cpu")


def test_other_paths_raise(saves, tmp_path):
    keeper = tmp_path / "top" / "0"
    keeper.mkdir(parents=True)
    torch.save({"encoder": {}, "head": {}}, keeper / "state.pt")
    with pytest.raises(KeyError, match="not a pretraining checkpoint"):
        load_model(str(keeper), device="cpu")
    orbax = tmp_path / "orbax" / "2"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError):
        load_model(str(orbax), device="cpu")
    with pytest.raises(NotImplementedError):
        train_freeze.load_encoder(str(orbax), "frame", "tiny", device="cpu")


def test_linear_probe_runs_on_a_step_directory(saves, tmp_path):
    res = train_freeze.main([
        "--pretrained_ckpt_path", saves["frame"], "--data_path",
        saves["data"], "--dataset_name", "audioset_b", "--model_type",
        "frame", "--arch", "tiny", "--n_last_blocks", "2", "--batch_size",
        "4", "--max_epochs", "2", "--train_len", "2.0", "--chunk_len_s",
        "1.0", "--save_path", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "result.json") as f:
        assert json.load(f) == res
    assert np.isfinite(res["val"]) and np.isfinite(res["test"])
