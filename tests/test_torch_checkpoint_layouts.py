"""Reference checkpoints in either patch-embed layout load into the port.

The reference encoders hold their patch embedding as a Linear
(``patch_embed.patch_embed.*``, [D, ph*pw]) or as a Conv2d with kernel =
stride (``patch_embed.proj.*``, [D, 1, ph, pw]); JAX's importer reads both
(``audiossl_tpu/compat/torch_import.py:59-71``) and ignores keys it does
not know. One ``frame_ast_tiny`` and one ``ast_tiny`` encoder are written
in both layouts, each file with one unknown key: ``load_model`` (frame)
and ``train_freeze.load_encoder`` (both) give bit-equal embeddings from
the two files, and a missing block key still raises. The Conv2d weight is
checked to be the layout's convolution, and an orbax path to be refused.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiossl_tpu_torch import embedding as temb
from audiossl_tpu_torch.compat.checkpoint import encoder_state_from_torch
from audiossl_tpu_torch.downstream.embedding import make_clip_extractor
from audiossl_tpu_torch.downstream.train_freeze import load_encoder
from audiossl_tpu_torch.models.atst import ast_tiny, frame_ast_tiny

PREFIX = "model.teacher.encoder."


def _write(path, sd, arch="tiny"):
    torch.save({"state_dict": {PREFIX + k: v for k, v in sd.items()},
                "hyper_parameters": {"arch": arch}}, path)
    return str(path)


def _layouts(enc, tmp_path, name):
    """(Linear file, Conv2d file) of ``enc``, each with an unknown key."""
    sd = dict(enc.state_dict())
    sd["unknown.extra_weight"] = torch.ones(3)
    w = sd.pop("patch_embed.patch_embed.weight")
    b = sd.pop("patch_embed.patch_embed.bias")
    lin = dict(sd, **{"patch_embed.patch_embed.weight": w,
                      "patch_embed.patch_embed.bias": b})
    conv = dict(sd, **{"patch_embed.proj.weight": w.reshape(
        w.shape[0], 1, enc.patch_h, enc.patch_w),
        "patch_embed.proj.bias": b})
    return (_write(tmp_path / f"{name}_linear.ckpt", lin),
            _write(tmp_path / f"{name}_conv.ckpt", conv))


def _encoder(maker, spec_w):
    return maker(spec_w=spec_w, device="cpu",
                 generator=torch.Generator().manual_seed(7))


def _wav(n, seed):
    return (np.random.RandomState(seed).randn(2, n) * 0.1).astype(np.float32)


def test_load_model_takes_both_layouts(tmp_path):
    enc = _encoder(frame_ast_tiny, temb.CHUNK_FRAMES)
    paths = _layouts(enc, tmp_path, "frame")
    wav = _wav(24000, 0)
    embs = [temb.get_scene_embedding(wav, temb.load_model(p, device="cpu"))
            for p in paths]
    assert torch.equal(embs[0], embs[1])
    with torch.no_grad():  # and both are the encoder that was written
        mel = torch.randn(2, 64, 101, generator=torch.Generator()
                          .manual_seed(1))
        want = enc.get_intermediate_layers(mel, torch.tensor([101, 50]))
        got = temb.load_model(paths[1], device="cpu").encoder \
            .get_intermediate_layers(mel, torch.tensor([101, 50]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["clip", "frame"])
def test_load_encoder_takes_both_layouts(kind, tmp_path):
    maker, spec_w = ((ast_tiny, 1001) if kind == "clip"
                     else (frame_ast_tiny, 601))
    paths = _layouts(_encoder(maker, spec_w), tmp_path, kind)
    encs = [load_encoder(p, kind, "tiny", spec_w=spec_w, device="cpu")
            for p in paths]
    wav, valid = _wav(32000, 1), np.asarray([32000, 20000])
    if kind == "clip":
        embs = [make_clip_extractor(e, crop_len_s=2.0, n_blocks=2)(wav, valid)
                for e in encs]
    else:
        mel = torch.randn(2, 64, spec_w, generator=torch.Generator()
                          .manual_seed(2))
        with torch.no_grad():
            embs = [e.get_intermediate_layers(mel, torch.tensor([601, 300]),
                                              n=2) for e in encs]
    assert torch.equal(embs[0], embs[1])
    assert all(not e.training and not any(p.requires_grad
                                          for p in e.parameters())
               for e in encs)


def test_missing_block_key_raises(tmp_path):
    sd = dict(_encoder(frame_ast_tiny, 1001).state_dict())
    del sd["blocks.1.mlp.fc2.bias"]
    path = _write(tmp_path / "broken.ckpt", sd)
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        temb.load_model(path, device="cpu")
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        load_encoder(path, "frame", "tiny", spec_w=1001, device="cpu")
    del sd["norm_frame.weight"], sd["norm_frame.bias"]
    sd["blocks.1.mlp.fc2.bias"] = torch.zeros(64)
    with pytest.raises(RuntimeError, match="norm_frame"):
        temb.load_model(_write(tmp_path / "no_norm.ckpt", sd), device="cpu")


def test_conv_layout_is_the_convolution():
    """The Conv2d layout's weight, reshaped as the importer reshapes it,
    computes the patch tokens the Conv2d computes (kernel = stride over
    the [B, 1, 64, T] mel)."""
    enc = _encoder(frame_ast_tiny, 101)
    w = enc.patch_embed.patch_embed.weight.detach()
    b = enc.patch_embed.patch_embed.bias.detach()
    conv_w = w.reshape(w.shape[0], 1, 64, 4)
    mapped = encoder_state_from_torch(
        {**{k: v for k, v in enc.state_dict().items()
            if not k.startswith("patch_embed.")},
         "patch_embed.proj.weight": conv_w, "patch_embed.proj.bias": b},
        enc.depth, use_cls=False)
    assert torch.equal(mapped["patch_embed.patch_embed.weight"], w)
    mel = torch.randn(2, 64, 101, generator=torch.Generator().manual_seed(3))
    want = F.conv2d(mel[:, None], conv_w, b, stride=(64, 4))  # [B, D, 1, W]
    want = want.flatten(2).transpose(1, 2)
    with torch.no_grad():
        x, _ = enc.prepare_tokens(mel, apply_mask=False)
        got = x - enc.pos_embed[:, 1:26]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_orbax_paths_are_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        load_encoder(str(tmp_path / "enc_params"), "clip", "tiny",
                     device="cpu")
