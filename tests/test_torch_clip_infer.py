"""The encoders' inference path against the JAX ``AudioTransformer`` (CPU).

Two properties of ``get_intermediate_layers``, the path serving runs:

* The clip encoder (``ast_tiny``: C=64, 2 blocks, 2 heads, CLS token) on
  weights carried over by ``state_dict_from_flax``, in f32, on the module
  path and on the block-kernel path (``fused=True``, whose kernel wrappers
  take their plain versions on the CPU), both ``scene`` modes. JAX prepends
  the CLS token and its position and masks the blocks' keys with
  ``plen + 1`` valid tokens; its scene mean runs over the first ``plen``
  rows of the normed output, the CLS row among them, and ``scene=False``
  keeps the CLS row. Lengths are ragged, one of them with no whole patch:
  the CLS token is then the one valid key, so unlike the frame encoder's
  (``tests/test_torch_encoder.py``) no sequence lacks a valid key, and
  every token on both routes is held to 2e-4.
* Fused serving in bf16: the port's ``load_model(fused=True)`` at
  frame-tiny against what JAX's ``load_model(fused=True)`` runs on a TPU,
  composed here from its parts: the bf16 encoder's ``prepare_tokens``,
  ``pallas_block.encoder_blocks_infer`` in interpret mode, the
  ``LayerNormPG`` final norm in bf16 and ``get_intermediate_layers``'
  masked mean, which divides by a weakly typed f32 count and so rounds to
  bf16 as well. Both sides round at the same points, so the bf16 outputs
  agree element for element except where an f32 sum taken in another order
  (XLA's against PyTorch's) lands a value on the other side of a bf16
  rounding boundary: one bf16 step (2^-8 relative). A few elements move
  so in the first block; the bf16 residual stream carries them into the
  second, after which many sit one step apart
  (``tests/test_torch_block_infer_q8.py`` sees the same on the float
  path). Held to rel L2 <= 3e-3 and >= 60% of the elements equal, both
  ``scene`` modes; the test prints both (``pytest -s``), and run against
  an encoder that rounds elsewhere it shows the distance that leaves. The
  sequence with no valid token (which JAX, padding N to a multiple of
  128, attends over 6 more keys) is held to finiteness. The port's
  embeddings are f32 casts of bf16 values, exactly.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models import transformer as jtr  # noqa: E402
from audiossl_tpu.ops import pallas_block as jpb  # noqa: E402
from audiossl_tpu_torch import embedding as temb  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import state_dict_from_flax  # noqa: E402
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402

SPEC_W = 201
LENGTHS = np.asarray([201, 122, 3], np.int32)  # patch counts 50, 30, 0
SERVE_LENGTHS = np.asarray([1001, 700, 3], np.int32)  # 250, 175, 0 patches
BF16_REL_L2, BF16_EQUAL = 3e-3, 0.6


def _perturbed_params(enc, mel, lengths, rng):
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(mel),
                      length=jnp.asarray(lengths), deterministic=True)["params"]
    # move LN scales/biases, the CLS token and zero biases off their init
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.randn(*a.shape)).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def clip_tiny():
    rng = np.random.RandomState(1)
    enc = jatst.ast_tiny(spec_w=SPEC_W)
    mel = rng.randn(3, 64, SPEC_W).astype(np.float32)
    return enc, _perturbed_params(enc, mel, LENGTHS, rng), mel


@pytest.mark.parametrize("scene", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_clip_get_intermediate_layers_matches_jax(clip_tiny, fused, scene):
    enc, params, mel = clip_tiny
    want = np.asarray(enc.apply(
        {"params": params}, jnp.asarray(mel), jnp.asarray(LENGTHS), n=2,
        scene=scene, deterministic=True,
        method=enc.get_intermediate_layers))
    port = tatst.ast_tiny(spec_w=SPEC_W, fused=fused, dtype=torch.float32,
                          device="cpu")
    port.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got = port.get_intermediate_layers(
            torch.from_numpy(mel), torch.from_numpy(LENGTHS), n=2,
            scene=scene).numpy()
    # scene=False: the CLS row and the 50 patches of the 201 frames
    assert got.shape == want.shape == ((3, 128) if scene else (3, 51, 128))
    np.testing.assert_allclose(got, want, atol=2e-4)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def frame_serving(tmp_path_factory):
    """JAX's fused bf16 encoder and its params, the port's
    ``load_model(fused=True)`` on the same weights, and a batch of mel
    chunks at the serving width."""
    rng = np.random.RandomState(2)
    enc = jatst.frame_ast_tiny(spec_w=temb.CHUNK_FRAMES)
    mel = rng.randn(3, 64, temb.CHUNK_FRAMES).astype(np.float32)
    params = _perturbed_params(enc, mel, SERVE_LENGTHS, rng)
    path = str(tmp_path_factory.mktemp("ckpt") / "atstframe_tiny.ckpt")
    sd = {f"model.teacher.encoder.{k}": v
          for k, v in state_dict_from_flax(params).items()}
    torch.save({"state_dict": sd, "hyper_parameters": {"arch": "tiny"}}, path)
    # the encoder JAX's load_model(fused=True) builds
    fused = jatst.frame_ast_tiny(spec_w=temb.CHUNK_FRAMES,
                                 fused_attention=True, fused_infer=True,
                                 dtype=jnp.bfloat16)
    return fused, params, temb.load_model(path, fused=True, device="cpu"), mel


def _jax_tpu_serving(enc, params, mel, lengths, n, scene):
    """``get_intermediate_layers`` of JAX's fused bf16 encoder as it runs on
    a TPU, where ``run_blocks`` takes the block kernels."""
    x, plen = enc.apply({"params": params}, jnp.asarray(mel),
                        jnp.asarray(lengths), method=enc.prepare_tokens)
    assert x.dtype == jnp.bfloat16
    _, collected = jpb.encoder_blocks_infer(
        params, x, plen, enc.num_heads, enc.depth, eps=enc.eps,
        collect_from=enc.depth - n, interpret=True)
    norm = jtr.LayerNormPG(epsilon=enc.eps, dtype=enc.dtype)
    outs = []
    for h in collected:
        norm_h = norm.apply({"params": params["norm"]}, h)
        if scene:
            mask = jtr.length_to_token_mask(plen, norm_h.shape[1])
            outs.append(jnp.sum(norm_h * mask[:, :, None], axis=1)
                        / (plen[:, None] + 1e-6))
        else:
            outs.append(norm_h)
    return np.asarray(jnp.concatenate(outs, axis=-1).astype(jnp.float32))


@pytest.mark.parametrize("scene", [True, False])
def test_fused_serving_rounds_where_jax_does(frame_serving, scene):
    enc, params, model, mel = frame_serving
    want = _jax_tpu_serving(enc, params, mel, SERVE_LENGTHS, 2, scene)
    with torch.inference_mode():
        got = model.encoder.get_intermediate_layers(
            torch.from_numpy(mel), torch.from_numpy(SERVE_LENGTHS), n=2,
            scene=scene)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    live = SERVE_LENGTHS // 4 > 0  # the sequences with a valid token
    rel, equal = _rel(got[live], want[live]), np.mean(got[live] == want[live])
    print(f"fused serving vs JAX's TPU composition, scene={scene}: rel L2 "
          f"{rel}, elements equal {equal}")
    assert np.all(np.isfinite(got))
    assert _bf16_cast(got)
    assert equal >= BF16_EQUAL
    assert rel <= BF16_REL_L2


def _bf16_cast(a):
    """Whether the f32 array holds bf16 values only (an exact cast)."""
    return not bool((torch.from_numpy(np.ascontiguousarray(a)).view(
        torch.int32) & 0xFFFF).any())


def test_fused_embeddings_are_bf16_values(frame_serving):
    """The public API under ``load_model(fused=True)``: the scene embedding
    (the chunk mean rounded to bf16, as JAX takes it over its bf16 chunk
    embeddings) and the timestamp embedding come back as f32 casts of
    bf16 values, over two chunks, the second with no valid token."""
    model = frame_serving[2]
    wav = (np.random.RandomState(5).randn(2, 160320) * 0.1).astype(
        np.float32)
    scene = temb.get_scene_embedding(wav, model)
    ts, _ = temb.get_timestamp_embedding(wav, model)
    assert scene.shape == (2, 2 * 64) and ts.shape == (2, 500, 2 * 64)
    for a in (scene, ts):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert _bf16_cast(a.numpy())
