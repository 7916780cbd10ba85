"""``python -m audiossl_tpu_torch.tools.verify_released`` against
``scripts/verify_released.py`` (CPU).

A seeded ATST-Frame small encoder is written as a reference-layout
``.ckpt`` with the top-level keys Lightning 2.2 saves (tensors and plain
values only, so ``torch.load(weights_only=True)`` reads it), beside a
16 kHz int16 WAV of 12 s (two chunks, the second partial). Small, not
tiny: JAX's ``.ckpt`` reader builds 12 blocks. Then:

* the port's ``--out`` is JAX's ``--golden`` and JAX's ``--out`` the
  port's (one JAX run does both): rc 0 each way, the port's embeddings
  within 2e-4 of JAX's (the bound of ``test_torch_embedding.py``);
* a golden off by 0.01 gives rc 1, one of another shape rc 1 with
  ``*_shape_mismatch``;
* ``--print-torch-recipe`` prints JAX's snippet exactly;
* probe mode hands the port's ``train_freeze.main`` JAX's argv plus
  ``--device`` and ``--n_devices 1`` (both ``main``s mocked) and gates on
  ``--expect``;
* no fallback: without ``--device`` the tool raises here (no card), and
  an orbax directory or a file ``weights_only`` refuses raises rather
  than giving rc 1.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from audiossl_tpu_torch.models.atst import frame_ast_small  # noqa: E402
from audiossl_tpu_torch.tools import verify_released as tvr  # noqa: E402

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
ATOL = 2e-4  # f32 on the CPU, as tests/test_torch_embedding.py holds


def _jax_script():
    sys.path.insert(0, str(SCRIPTS))
    try:
        import verify_released
    finally:
        sys.path.pop(0)
    return verify_released


def lightning_ckpt(state_dict, hparams):
    """A checkpoint with the top-level keys Lightning 2.2 writes, holding
    tensors and plain values only."""
    return {
        "epoch": 3, "global_step": 1200,
        "pytorch-lightning_version": "2.2.0",
        "state_dict": state_dict,
        "loops": {"fit_loop": {
            "state_dict": {}, "epoch_progress": {
                "total": {"ready": 4, "started": 4, "processed": 3,
                          "completed": 3}},
            "epoch_loop.state_dict": {"_batches_that_stepped": 1200}}},
        "callbacks": {"ModelCheckpoint{'monitor': None}": {
            "best_model_score": None, "best_model_path": "",
            "last_model_path": "last.ckpt", "dirpath": "ckpt"}},
        "optimizer_states": [{
            "state": {0: {"step": torch.tensor(1200.0),
                          "exp_avg": torch.zeros(3),
                          "exp_avg_sq": torch.zeros(3)}},
            "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999),
                              "eps": 1e-8, "weight_decay": 0.04,
                              "params": [0]}]}],
        "lr_schedulers": [{"base_lrs": [1e-4], "last_epoch": 1200}],
        "hparams_name": "kwargs",
        "hyper_parameters": hparams,
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("verify_released")
    enc = frame_ast_small(spec_w=1001, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    sd = {f"model.teacher.encoder.{k}": v
          for k, v in enc.state_dict().items()}
    ckpt = d / "atstframe_small.ckpt"
    torch.save(lightning_ckpt(sd, {"arch": "small", "lr": 1e-4,
                                   "max_steps": 1200}), ckpt)
    wav = d / "clip.wav"
    rng = np.random.RandomState(0)
    wavfile.write(wav, 16000, (rng.randn(192000) * 3000).astype(np.int16))
    return d, str(ckpt), str(wav)


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def outputs(files):
    """The port's ``--out`` first, then one JAX run that writes its own
    ``--out`` and reads the port's as ``--golden``."""
    d, ckpt, wav = files
    base = ["--ckpt", ckpt, "--wav", wav]
    port_out, jax_out = str(d / "port.npz"), str(d / "jax.npz")
    rc_port = tvr.main(base + ["--device", "cpu", "--out", port_out])
    rc_jax = _jax_script().main(base + ["--out", jax_out,
                                        "--golden", port_out])
    return base, port_out, jax_out, rc_port, rc_jax


def test_jax_reads_the_ports_output(outputs):
    _, port_out, jax_out, rc_port, rc_jax = outputs
    assert rc_port == 0 and rc_jax == 0
    got, want = np.load(port_out), np.load(jax_out)
    assert set(got.files) == set(want.files) == {"scene", "timestamp",
                                                 "timestamps_ms"}
    for k in got.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    assert got["scene"].shape == (1, 12 * 384)
    assert got["timestamp"].shape == (1, 2 * 250, 12 * 384)


def test_port_reads_jaxs_output(outputs, capsys):
    base, _, jax_out, _, _ = outputs
    rc, res = _run(tvr.main, base + ["--device", "cpu", "--golden", jax_out],
                   capsys)
    assert rc == 0 and res["ok"], res
    assert res["scene_max_abs_diff"] <= ATOL
    assert res["timestamp_max_abs_diff"] <= ATOL
    assert res["scene_shape"] == [1, 4608]
    assert res["timestamp_shape"] == [1, 500, 4608] and res["tol"] == 1e-3


@pytest.mark.parametrize("change", ["perturbed", "reshaped"])
def test_golden_beyond_tolerance_fails(outputs, tmp_path, capsys, change):
    base, _, jax_out, _, _ = outputs
    g = dict(np.load(jax_out))
    if change == "perturbed":
        g["scene"] = g["scene"] + 0.01
    else:
        g["timestamp"] = g["timestamp"][:, :250]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **g)
    rc, res = _run(tvr.main, base + ["--device", "cpu", "--golden", bad],
                   capsys)
    assert rc == 1 and not res["ok"], res
    if change == "perturbed":
        assert res["scene_max_abs_diff"] > 1e-3
        assert res["timestamp_max_abs_diff"] <= ATOL
    else:
        assert res["timestamp_shape_mismatch"] == [1, 250, 4608]
        assert "timestamp_max_abs_diff" not in res


def test_print_torch_recipe_is_jaxs(capsys):
    jvr = _jax_script()
    assert tvr.TORCH_RECIPE == jvr.TORCH_RECIPE
    assert tvr.main(["--print-torch-recipe"]) == 0
    assert capsys.readouterr().out == jvr.TORCH_RECIPE + "\n"


def test_probe_mode_passes_jaxs_argv(monkeypatch, capsys):
    from audiossl_tpu.downstream import train_freeze as jtf
    from audiossl_tpu_torch.downstream import train_freeze as ttf

    seen = {}

    def fake(key):
        def main(argv):
            seen[key] = list(argv)
            return {"test": 0.953}
        return main

    monkeypatch.setattr(jtf, "main", fake("jax"))
    monkeypatch.setattr(ttf, "main", fake("port"))
    jvr = _jax_script()
    for extra in ([], ["--max_epochs", "3"]):
        base = ["probe", "--ckpt", "c", "--dataset_name", "spcv2",
                "--data_path", "d", "--model_type", "clip",
                "--arch", "small", "--tol", "0.01", *extra]
        assert jvr.main(base + ["--expect", "0.958"]) == 0
        rc, res = _run(tvr.main, base + ["--expect", "0.958", "--device",
                                         "cpu"], capsys)
        diff = res.pop("abs_diff")
        assert rc == 0 and res == {"dataset": "spcv2", "test_score": 0.953,
                                   "expect": 0.958, "tol": 0.01, "ok": True}
        assert abs(diff - 0.005) < 1e-12
        assert seen["port"] == seen["jax"] + ["--device", "cpu",
                                              "--n_devices", "1"]
        rc, res = _run(tvr.main, base + ["--expect", "0.90", "--device",
                                         "cpu"], capsys)
        assert rc == 1 and not res["ok"]


def test_no_fallback(files, tmp_path, monkeypatch):
    d, ckpt, wav = files
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tvr.main(["--ckpt", ckpt, "--wav", wav])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tvr.main(["probe", "--ckpt", ckpt, "--dataset_name", "spcv2",
                      "--data_path", str(d), "--expect", "0.9"])
    orbax = tmp_path / "atst_small"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="export_orbax_ckpt"):
        tvr.main(["--ckpt", str(orbax), "--wav", wav, "--device", "cpu"])
    # Lightning may pickle hyper-parameters as a Namespace: weights_only
    # refuses the file, and the tool raises
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    sd["hyper_parameters"] = argparse.Namespace(arch="small")
    pickled = tmp_path / "namespace.ckpt"
    torch.save(sd, pickled)
    with pytest.raises(Exception, match="weights_only"):
        tvr.main(["--ckpt", str(pickled), "--wav", wav, "--device", "cpu"])
