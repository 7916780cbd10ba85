"""The ported slice as a whole: the public embedding API against the JAX
package's, on frame-tiny at the serving chunk width (spec_w=1001).

The port's model is loaded by ``load_model`` from a reference-layout
Lightning ``.ckpt`` holding the JAX params carried over by
``state_dict_from_flax``. 48,000 samples give one ragged chunk; 160,320
samples give two chunks, the second with 3 frames and so no valid token
(its scene weight is 0; its timestamp rows are the module path's output
over masked keys, held to the encoder test's ``ZERO_VALID_ATOL``).
Tolerance 2e-4 otherwise (CPU, f32).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu import embedding as jemb  # noqa: E402
from audiossl_tpu.models.atst import frame_ast_tiny  # noqa: E402
from audiossl_tpu_torch import embedding as temb  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import state_dict_from_flax  # noqa: E402

ZERO_VALID_ATOL = 2e-3  # see tests/test_torch_encoder.py


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The JAX model and the path of its reference-layout ``.ckpt``."""
    rng = np.random.RandomState(0)
    enc = frame_ast_tiny(spec_w=jemb.CHUNK_FRAMES)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 1001)),
                      length=jnp.asarray([1001]), deterministic=True)["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.randn(*a.shape)).astype(
            np.float32), params)
    path = str(tmp_path_factory.mktemp("ckpt") / "atstframe_tiny.ckpt")
    sd = {f"model.teacher.encoder.{k}": v
          for k, v in state_dict_from_flax(params).items()}
    torch.save({"state_dict": sd, "hyper_parameters": {"arch": "tiny"}}, path)
    return jemb.EmbeddingModel(encoder=enc, params=params), path


@pytest.fixture(scope="module")
def models(ckpt):
    jmodel, path = ckpt
    return jmodel, temb.load_model(path, device="cpu")


@pytest.mark.parametrize("kind", ["scene", "timestamp"])
@pytest.mark.parametrize("n", [48000, 160320])
def test_embedding_matches_jax(models, n, kind):
    jmodel, tmodel = models
    wav = (np.random.RandomState(n).randn(2, n) * 0.1).astype(np.float32)
    if kind == "scene":
        want = np.asarray(jemb.get_scene_embedding(wav, jmodel))
        got = temb.get_scene_embedding(wav, tmodel).numpy()
        assert got.shape == want.shape == (2, 2 * 64)
        np.testing.assert_allclose(got, want, atol=2e-4)
        return
    want, wts = jemb.get_timestamp_embedding(wav, jmodel)
    got, ts = temb.get_timestamp_embedding(wav, tmodel)
    np.testing.assert_allclose(ts.numpy(), np.asarray(wts))
    got, want = got.numpy(), np.asarray(want)
    nc = -(-(n // 160 + 1) // 1001)
    assert got.shape == want.shape == (2, nc * 250, 2 * 64)
    np.testing.assert_allclose(got[:, :250], want[:, :250], atol=2e-4)
    if nc == 2:  # the chunk with no valid token
        np.testing.assert_allclose(got[:, 250:], want[:, 250:],
                                   atol=ZERO_VALID_ATOL)


@pytest.mark.parametrize("path, kw, err", [
    ("model.ckpt", dict(quant="int8"), ValueError),  # needs fused=True
    ("model.ckpt", dict(quant="fp8"), ValueError),
    ("exp/atst_small", {}, NotImplementedError),  # an orbax directory
])
def test_load_model_refuses_what_is_not_ported(path, kw, err):
    with pytest.raises(err):
        temb.load_model(path, device="cpu", **kw)


def test_load_model_runs_on_the_card_unless_asked_for_the_cpu():
    """The card is the default device; without one, load_model raises
    before it reads anything, with a message that names the way out."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        temb.load_model("model.ckpt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        temb.load_model("model.ckpt", device="cuda", fused=True,
                        quant="int8")


def test_int8_serving_runs_k2q_k3q_and_tracks_bf16(ckpt, monkeypatch):
    """``load_model(fused=True, quant="int8")`` keeps the f32 weights and
    runs every block through K2q/K3q (their plain versions on the CPU);
    its scene embedding stays within cosine 0.99 of the bf16 fused
    model's (the JAX package's int8 budget: ~1e-2 relative per block)."""
    from audiossl_tpu_torch.ops import block_infer as tbi

    calls = {"attn_block_infer_q8": 0, "mlp_block_infer_q8": 0}
    for name in calls:
        def counted(*a, _fn=getattr(tbi, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tbi, name, counted)
    path = ckpt[1]
    q8 = temb.load_model(path, fused=True, quant="int8", device="cpu")
    assert all(p.dtype == torch.float32 for p in q8.encoder.parameters())
    bf = temb.load_model(path, fused=True, device="cpu")
    wav = (np.random.RandomState(3).randn(2, 48000) * 0.1).astype(np.float32)
    got = temb.get_scene_embedding(wav, q8)
    depth = len(q8.encoder.blocks)
    assert calls == {"attn_block_infer_q8": depth,
                     "mlp_block_infer_q8": depth}
    want = temb.get_scene_embedding(wav, bf)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(),
                                                dim=-1)
    assert float(cos.min()) >= 0.99, cos
