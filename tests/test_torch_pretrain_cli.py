"""The port's pretraining CLIs (``python -m
audiossl_tpu_torch.methods.atstframe.train`` and ``...methods.atst.train``)
against the JAX package's on the CPU.

Each parser has JAX's flags (dest, option strings, default, choices,
nargs, required, and the same values from ``type``) plus ``--device``; for
several argument lists the port's config equals JAX's field by field,
the scaled learning rate included (exactly: the same float operations);
``main`` runs each CLI end to end at tiny width on a synthetic pack,
writes ``ckpt/`` and resumes, and on 2 gloo ranks that it starts itself
(``--n_devices 2``, with and without ``--shard_optimizer``).
``torch.utils.tensorboard`` is kept from importing (it loads TensorFlow
when that is installed).
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from audiossl_tpu.methods.atst import train as jclip
from audiossl_tpu.methods.atstframe import train as jframe
from audiossl_tpu_torch.datasets import write_synthetic_pack
from audiossl_tpu_torch.methods.atst import train as tclip
from audiossl_tpu_torch.methods.atstframe import train as tframe
from audiossl_tpu_torch.utils.common import bool_flag

CLIS = {"frame": (jframe, tframe), "clip": (jclip, tclip)}
TINY = {"frame": ["--arch", "tiny", "--anchor_len", "1.0"],
        "clip": ["--arch", "tiny", "--anchor_len", "1.0", "1.0",
                 "--positive_len", "1.0", "1.0"]}


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("which", sorted(CLIS))
def test_parser_has_jax_flags_and_device(which):
    jmod, tmod = CLIS[which]
    want, got = _actions(jmod.build_parser()), _actions(tmod.build_parser())
    assert set(got) == set(want) | {"device"}
    assert got["device"].default == "cuda"
    for dest, w in want.items():
        g = got[dest]
        for attr in ("option_strings", "default", "choices", "nargs",
                     "required", "const"):
            assert getattr(g, attr) == getattr(w, attr), (dest, attr)
        assert (g.type is None) == (w.type is None), dest
        if w.type is None:
            continue
        for s in ("true", "off", "1", "0", "3", "2.5", "ON"):
            try:
                ref = w.type(s)
            except Exception as e:  # noqa: BLE001
                with pytest.raises(type(e)):
                    g.type(s)
                continue
            assert g.type(s) == ref, (dest, s)


ARGVS = {
    "frame": [
        [],
        ["--arch", "base", "--subset", "3000000", "--batch_size_per_device",
         "144", "--learning_rate", "8e-5", "--ema", "0.9996",
         "--warmup_steps", "19900", "--max_steps", "398000", "--anchor_len",
         "10.0", "--mask_type", "block", "--mask_ratio", "0.65",
         "--mask_len", "5", "--aug_tea", "false", "--aug_stu", "true"],
        ["--avg_blocks", "8", "--pos_type", "interpolate", "--dtype",
         "float32", "--symmetric", "off", "--aug_tea", "TRUE",
         "--mix_up", "0", "--freq_wrap", "false", "--mask_type", "random",
         "--min_mask_len", "3"],
        ["--teacher_quant", "int8", "--student_quant", "int8dx",
         "--batch_size_per_device", "96", "--learning_rate", "1e-3"],
    ],
    "clip": [
        [],
        ["--arch", "small", "--subset", "200000", "--batch_size_per_device",
         "384", "--learning_rate", "5e-4", "--ema", "0.99",
         "--warmup_steps", "1300", "--max_steps", "39010", "--anchor_len",
         "9.0", "9.0", "--positive_len", "9.0", "9.0"],
        ["--anchor_len", "4", "5", "--virtual_crop", "1.2", "--dtype",
         "float32", "--arch", "base", "--batch_size_per_device", "100"],
    ],
}


def _jax_config(jmod, argv, monkeypatch):
    """The config JAX's ``main`` builds (its dataset and run loop
    stubbed), on one device."""
    seen = {}
    monkeypatch.setattr(jmod, "PackedAudioDataset", lambda *a, **k: None)
    monkeypatch.setattr(jmod, "run_pretraining",
                        lambda method, *a, **k: seen.setdefault("m", method))
    jmod.main(["--data_path", "unused", "--n_devices", "1", *argv])
    return seen["m"].cfg


@pytest.mark.parametrize("which, i", [(w, i) for w in sorted(ARGVS)
                                      for i in range(len(ARGVS[w]))])
def test_config_equals_jax(which, i, monkeypatch):
    jmod, tmod = CLIS[which]
    argv = ARGVS[which][i]
    want = _jax_config(jmod, argv, monkeypatch)
    args = tmod.build_parser().parse_args(["--data_path", "unused", *argv])
    got = tmod.build_config(args)
    w, g = dataclasses.asdict(want), dataclasses.asdict(got)
    assert set(g) - set(w) == {"drop_path_rate"}
    assert g["drop_path_rate"] == 0.1  # the JAX encoders' default
    for k in w:
        if isinstance(w[k], dict):
            assert set(g[k]) == set(w[k]), k
        assert g[k] == w[k], k
    assert got.optimizer.learning_rate == (
        args.learning_rate * args.batch_size_per_device / 256.0)


@pytest.mark.parametrize("which", sorted(CLIS))
def test_main_trains_checkpoints_and_resumes(which, tmp_path, capsys):
    data, save = str(tmp_path / "data"), str(tmp_path / "exp")
    write_synthetic_pack(data, "train", 7, min_s=0.5, max_s=1.5, seed=1)
    tmod = CLIS[which][1]
    argv = ["--data_path", data, "--save_path", save, "--device", "cpu",
            "--batch_size_per_device", "2", "--warmup_steps", "1",
            "--ckpt_interval", "2", "--subset", "6", *TINY[which]]
    state = tmod.main(argv + ["--max_steps", "3"])
    out = capsys.readouterr().out
    assert state.step == 3 and "loader: native" in out
    assert sorted(os.listdir(os.path.join(save, "ckpt"))) == ["2", "3"]
    assert np.isfinite(float(next(iter(state.mu.values())).sum()))
    state = tmod.main(argv + ["--max_steps", "5"])
    out = capsys.readouterr().out
    assert "resumed from step 3\n" in out
    assert "run ended at step 5: 2 steps taken" in out
    # the three latest saves stay
    assert sorted(os.listdir(os.path.join(save, "ckpt"))) == ["3", "4", "5"]


@pytest.mark.parametrize("flag", [["--n_devices", "2"],
                                  ["--n_devices", "2", "--shard_optimizer"]])
@pytest.mark.parametrize("which", sorted(CLIS))
def test_more_than_one_device_raises(which, flag, tmp_path, capfd):
    """(Named when these flags raised.) ``main`` starts 2 gloo ranks
    itself: 2 steps of the global batch of 4, rank 0 prints and writes the
    checkpoint, whose learning rate scales with the 2 ranks."""
    data, save = str(tmp_path / "data"), str(tmp_path / "exp")
    write_synthetic_pack(data, "train", 9, min_s=0.5, max_s=1.0, seed=1)
    tmod = CLIS[which][1]
    argv = ["--data_path", data, "--save_path", save, "--device", "cpu",
            "--batch_size_per_device", "2", "--warmup_steps", "1",
            "--max_steps", "2", "--ckpt_interval", "2", *TINY[which], *flag]
    assert tmod.main(argv) is None  # the ranks ran in their own processes
    out = capfd.readouterr().out
    assert "(rank 0 of 2), 2 batches of 4 an epoch" in out
    assert out.count("run ended at step 2: 2 steps taken") == 1
    assert sorted(os.listdir(os.path.join(save, "ckpt"))) == ["2"]
    saved = torch.load(os.path.join(save, "ckpt", "2", "state.pt"),
                       weights_only=True)
    assert saved["step"] == saved["count"] == 2
    assert all(bool(torch.isfinite(v).all()) for v in saved["mu"].values())
    args = tmod.build_parser().parse_args(argv)
    assert tmod.build_config(args).optimizer.learning_rate == (
        args.learning_rate * 2 * args.batch_size_per_device / 256.0)


def test_bool_flag_is_jax_bool_flag():
    for s in ("on", "TRUE", "1", "off", "False", "0"):
        assert bool_flag(s) == jframe.bool_flag(s)
    with pytest.raises(Exception):
        bool_flag("yes")
