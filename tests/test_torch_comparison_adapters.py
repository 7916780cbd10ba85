"""The eight comparison adapters of ``downstream.comparison_models`` against
the JAX package's (CPU), each built by ``get_adapter`` from one seeded
random checkpoint file in its authors' layout (``compat.synthetic``, 128
wide, 2 layers; BYOL-A's fixed CNN):

* ``embed_dim``, ``frame_rate_divisor``, ``token_count`` (at 1, 1.3 and
  10 s) and ``frame_embeddings`` of two 1.3 s clips, one padded, f32 rel L2
  <= 1e-5 (a front end within 1e-4 feeds them, so its rounding shows
  at most as far);
* one ``SEDTask`` step with ``maeast`` (finetuned: K6's plain backward,
  the BatchNorm statistics trained) and with ``byola`` (its running
  statistics fixed) against JAX's ``SEDTask`` step from the same weights
  and head: the loss rel <= 1e-5, the parameters rel L2 <= 1e-5 (their
  update 1e-4; each leaf rtol 1e-5, atol 2e-5 as
  ``test_torch_sed_task.py`` holds its steps); the
  port's ``SEDTask`` takes its device from any encoder (BEATs and BYOL-A
  have no ``pos_embed``) and draws no drop path for an adapter;
* ``train_dcase --arch maeast --device cpu`` and ``train_as_strong --arch
  beats --freeze_mode --device cpu`` end to end on written SED trees;
* ``EnsembleModel`` and ``cal_norm`` against JAX's.
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.downstream import comparison_models as jcm  # noqa: E402
from audiossl_tpu.sed import module as jmodule  # noqa: E402
from audiossl_tpu_torch.compat import synthetic  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import sed_state_from_flax  # noqa: E402
from audiossl_tpu_torch.downstream import comparison_models as cm  # noqa: E402
from audiossl_tpu_torch.sed import module  # noqa: E402
from test_torch_compat_encoders import SMALL, flax_to_port  # noqa: E402

L = 20800  # 1.3 s


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapters")
    out = {}
    for i, arch in enumerate(synthetic.ARCHS):
        path = str(root / f"{arch}.pt")
        torch.save(synthetic.authors_checkpoint(arch, seed=30 + i, **SMALL),
                   path)
        out[arch] = path
    return out


def _wave(B=2, n=L, seed=0):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(B, n) * 0.1).astype(np.float32)
    valid = np.full(B, n, np.int32)
    valid[1::2] = n * 3 // 5
    for i, v in enumerate(valid):
        wav[i, v:] = 0.0
    return wav, valid


@pytest.mark.parametrize("arch", synthetic.ARCHS)
def test_adapter_matches_jax(files, arch):
    jad = jcm.get_adapter(arch, ckpt_path=files[arch])
    ad = cm.get_adapter(arch, ckpt_path=files[arch], device="cpu")
    assert ad.embed_dim == jad.embed_dim
    assert ad.frame_rate_divisor == jad.frame_rate_divisor
    for n in (16000, L, 160000):
        assert ad.token_count(n) == jad.token_count(n), n
    wav, valid = _wave()
    want = np.asarray(jad.frame_embeddings(jad.params, jnp.asarray(wav),
                                           jnp.asarray(valid)))
    with torch.no_grad():
        got = ad.frame_embeddings(torch.from_numpy(wav),
                                  torch.from_numpy(valid).long()).numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.shape[1] == ad.token_count(L) and got.shape[2] == ad.embed_dim
    assert np.isfinite(want).all()
    assert _rel(got, want) <= 1e-5, _rel(got, want)


def _sed_batch(rng, B=4, T=25, C=3):
    wav, valid = _wave(B, 16000, seed=5)
    return {"wav": wav, "valid": valid,
            "strong": (rng.rand(B, T, C) > 0.7).astype(np.float32),
            "source": np.asarray([0, 0, 1, 1], np.int32)}


@pytest.mark.parametrize("arch", ["maeast", "byola"])
def test_sed_step_matches_jax(files, arch):
    common = dict(num_labels=3, learning_rate=0.1, max_epochs=2,
                  steps_per_epoch=1, warmup_epochs=0)
    jad = jcm.get_adapter(arch, ckpt_path=files[arch])
    jtask = jmodule.SEDTask(jad, jmodule.SEDConfig(**common, audio_len=1.0))
    jstate = jtask.init_state(jax.random.PRNGKey(1), jad.params)
    batch = _sed_batch(np.random.RandomState(4))
    jstate2, jm = jax.jit(jtask.make_train_step())(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    ad = cm.get_adapter(arch, ckpt_path=files[arch], device="cpu")
    task = module.SEDTask(ad, module.SEDConfig(**common))
    assert task.device == torch.device("cpu")
    assert task.factors is None  # no layer decay for an adapter
    _, head = sed_state_from_flax(None, jstate.head_params)
    task.head.load_state_dict(head)
    state = task.init_state()
    before = {k: p.detach().numpy().copy() for k, p in state.params.items()}
    assert task.draw(torch.Generator().manual_seed(0), 4) is None
    stats = {k: v.clone() for k, v in ad.encoder.state_dict().items()
             if "running" in k}
    state, m = task.train_step(state, batch, None)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"])), (float(m["loss"]), float(jm["loss"]))
    want = {f"encoder.{k}": v for k, v in
            flax_to_port(jax.device_get(jstate2.enc_params)).items()}
    _, jhead = sed_state_from_flax(None, jstate2.head_params)
    want.update((f"head.{k}", v.numpy()) for k, v in jhead.items())
    got = {k: p.detach().numpy() for k, p in state.params.items()}
    assert set(got) == set(want), set(got) ^ set(want)
    keys = sorted(got)
    flat = [np.concatenate([d[k].ravel() for k in keys])
            for d in (got, want, before)]
    assert _rel(flat[0], flat[1]) <= 1e-5, _rel(flat[0], flat[1])
    # the step itself: what it moved the parameters by
    assert _rel(flat[0] - flat[2], flat[1] - flat[2]) <= 1e-4, \
        _rel(flat[0] - flat[2], flat[1] - flat[2])
    # each leaf as test_torch_sed_task.py holds its steps' (a head bias
    # that starts at 0 holds its update alone, ~5e-5)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-5,
                                   err_msg=k)
    if arch == "maeast":  # the BatchNorm statistics are trained
        for k in ("encoder.bn_mean", "encoder.bn_var"):
            assert got[k] != before[k], k
    for k, v in ad.encoder.state_dict().items():  # BYOL-A's stay fixed
        if "running" in k:
            assert torch.equal(v, stats[k]), k


@pytest.mark.parametrize("arch", ["beats", "byola"])
def test_sed_task_takes_any_encoder(files, arch):
    """The encoders without ``pos_embed`` or ``depth``: the task builds on
    the encoder's device, with no drop-path draws, and predicts."""
    ad = cm.get_adapter(arch, ckpt_path=files[arch], device="cpu")
    assert not hasattr(ad.encoder, "pos_embed")
    task = module.SEDTask(ad, module.SEDConfig(num_labels=3))
    state = task.init_state()
    assert task.draw(torch.Generator().manual_seed(0), 2) is None
    wav, valid = _wave(2, 16000)
    strong, weak = task.predict(state, {"wav": wav, "valid": valid})
    assert strong.shape == (2, 3, ad.token_count(16000))
    assert weak.shape == (2, 3) and bool(torch.isfinite(strong).all())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from audiossl_tpu_torch.datasets import sed

    root = tmp_path_factory.mktemp("comparison_sed")
    dcase, as_strong = str(root / "dcase"), str(root / "as_strong")
    sed.write_synthetic_sed(
        dcase, {"synth_train": 4, "weak_train": 6, "synth_val": 3,
                "strong_val": 3}, sed.DCASE_CLASSES,
        weak_splits=("weak_train",), duration_splits=("strong_val",),
        seed=6, seconds=2.0)
    sed.write_synthetic_sed(as_strong, {"train": 4, "val": 3, "eval": 3},
                            ["/m/a", "/m/b", "/m/c"], seed=7, seconds=2.0)
    return root, dcase, as_strong


@pytest.mark.parametrize("driver,arch", [("train_dcase", "maeast"),
                                         ("train_as_strong", "beats")])
def test_sed_drivers_run_a_comparison_encoder(files, trees, driver, arch):
    from audiossl_tpu_torch.downstream import train_as_strong, train_dcase

    root, dcase, as_strong = trees
    save = str(root / f"{driver}_{arch}")
    common = ["--pretrained_ckpt_path", files[arch], "--arch", arch,
              "--max_epochs", "2", "--warmup_epochs", "1", "--save_path",
              save, "--device", "cpu", "--n_devices", "1"]
    if driver == "train_dcase":
        res = train_dcase.main(common + [
            "--data_path", dcase, "--batch_size_synth", "2",
            "--batch_size_weak", "2", "--learning_rate", "0.01"])
    else:
        res = train_as_strong.main(common + [
            "--data_path", as_strong, "--batch_size", "2", "--freeze_mode"])
    with open(os.path.join(save, "result.json")) as f:
        assert json.load(f) == res
    assert set(res) == {"psds1", "psds2", "event_f1"}
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())


def test_ensemble_and_cal_norm_match_jax():
    rng = np.random.RandomState(8)
    a, b = rng.randn(3, 5), rng.randn(3, 5)
    fns = [lambda x: x * a, lambda x: x * b]
    np.testing.assert_array_equal(cm.EnsembleModel(fns)(2.0),
                                  jcm.EnsembleModel(fns)(2.0))
    batches = [{"wav": rng.randn(4, 6).astype(np.float32),
                "valid": np.full(4, 6)} for _ in range(3)]

    def extract(wav, valid):
        return wav[:, :3] * 2.0 + 1.0

    want = jcm.cal_norm(lambda w, v: jnp.asarray(extract(w, v)), batches)
    got = cm.cal_norm(lambda w, v: torch.from_numpy(extract(w, v)), batches)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
