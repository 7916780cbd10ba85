"""An orbax directory of the JAX package served by the port through
``scripts/export_orbax_ckpt.py`` (CPU).

The test writes a jittered frame-tiny encoder's params with JAX's
``training.checkpoint.save_params``, runs the exporter as a user does
(``python scripts/export_orbax_ckpt.py DIR OUT.ckpt``), and
holds the port's ``load_model`` on the ``.ckpt`` against JAX's
``load_model`` on the directory: every tensor equal to JAX's restored
params, scene and timestamp embeddings of one 3 s clip within rel L2
1e-5. ``train_freeze.load_encoder`` reads the same file, and the port's
loaders still refuse the directory, naming the exporter.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu import embedding as jemb  # noqa: E402
from audiossl_tpu.models.atst import frame_ast_tiny  # noqa: E402
from audiossl_tpu.training.checkpoint import save_params  # noqa: E402
from audiossl_tpu_torch import embedding as temb  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import state_dict_from_flax  # noqa: E402
from audiossl_tpu_torch.downstream import train_freeze  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    rng = np.random.RandomState(0)
    enc = frame_ast_tiny(spec_w=jemb.CHUNK_FRAMES)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 1001)),
                      length=jnp.asarray([1001]), deterministic=True)["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.randn(*a.shape)).astype(
            np.float32), params)
    orbax_dir = str(root / "atst_tiny")
    save_params(orbax_dir, params)
    out = str(root / "exported" / "atst_tiny.ckpt")
    r = subprocess.run([sys.executable, "scripts/export_orbax_ckpt.py",
                        orbax_dir, out], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"wrote {out}" in r.stdout and "arch tiny" in r.stdout
    return orbax_dir, out, params


def test_export_layout(exported):
    orbax_dir, out, params = exported
    ckpt = torch.load(out, map_location="cpu", weights_only=True)
    # the tier is read off the tensors: width 64, 2 blocks
    assert ckpt["hyper_parameters"] == {"arch": "tiny"}
    want = state_dict_from_flax(params)
    assert set(ckpt["state_dict"]) == {f"model.teacher.encoder.{k}"
                                       for k in want}
    for k, v in want.items():
        assert torch.equal(ckpt["state_dict"][f"model.teacher.encoder.{k}"],
                           v), k


@pytest.mark.parametrize("kind", ["scene", "timestamp"])
def test_exported_ckpt_serves_as_jax_serves_the_directory(exported, kind):
    orbax_dir, out, _ = exported
    jmodel = jemb.load_model(orbax_dir, arch="tiny")
    model = temb.load_model(out, device="cpu")
    wav = (np.random.RandomState(1).randn(1, 48000) * 0.1).astype(np.float32)
    if kind == "scene":
        want = np.asarray(jemb.get_scene_embedding(wav, jmodel))
        got = temb.get_scene_embedding(wav, model).numpy()
    else:
        want = np.asarray(jemb.get_timestamp_embedding(wav, jmodel)[0])
        got = temb.get_timestamp_embedding(wav, model)[0].numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5, _rel(got, want)


def test_load_encoder_reads_the_export_and_the_directory_is_refused(exported):
    orbax_dir, out, params = exported
    enc = train_freeze.load_encoder(out, "frame", "tiny", spec_w=1001,
                                    device="cpu")
    want = state_dict_from_flax(params)
    got = enc.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for load in (lambda: temb.load_model(orbax_dir, device="cpu"),
                 lambda: train_freeze.load_encoder(orbax_dir, "frame",
                                                   "tiny", device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="scripts/export_orbax_ckpt.py"):
            load()
