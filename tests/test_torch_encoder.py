"""The port's frame encoder against the JAX ``AudioTransformer`` (CPU, f32).

Frame-tiny (C=64, 2 blocks, 2 heads) on weights carried over by
``state_dict_from_flax``, with ragged lengths including a sample whose
patch count is 0. The module path (``fused=False``) is compared on all
tokens; the block-kernel path (``fused=True`` built in f32, whose
kernel wrappers take their plain versions on the CPU) on the valid
tokens, since it masks keys by validity columns instead of the additive
-10000 mask. Tolerance 2e-4, except on the module path's sample with no
valid token (see ``ZERO_VALID_ATOL``).

The downstream APIs in training form (drop path through each of them,
with every gradient) are held to JAX's as their test says; a reference
``prompt_embed`` is left out of a port encoder built without prompt
tokens (``test_torch_heldout_api.py`` holds one built with them).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.compat.torch_import import encoder_params_from_torch  # noqa: E402
from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models import transformer as jtr  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import (  # noqa: E402
    load_encoder_state,
    state_dict_from_flax,
    strip_prefixes,
)
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402
from audiossl_tpu_torch.models import transformer as ttr  # noqa: E402

SPEC_W = 201
LENGTHS = np.asarray([201, 122, 3], np.int32)  # patch counts 50, 30, 0
# With every key masked, the module path's scores are s - 10000 in f32,
# whose spacing there is 2^-10 (~1e-3): a 1e-7 difference in s between
# the frameworks can move a score by one such step, so the tokens of a
# sample with no valid token are held to 2e-3.
ZERO_VALID_ATOL = 2e-3


@pytest.fixture(scope="module")
def frame_tiny():
    rng = np.random.RandomState(0)
    enc = jatst.frame_ast_tiny(spec_w=SPEC_W)
    mel = rng.randn(3, 64, SPEC_W).astype(np.float32)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(mel),
                      length=jnp.asarray(LENGTHS), deterministic=True)["params"]
    # move LN scales/biases and zero biases off their init values
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.randn(*a.shape)).astype(
            np.float32), params)
    return enc, params, mel


def _jax_layers(enc, params, mel, scene):
    return np.asarray(enc.apply(
        {"params": params}, jnp.asarray(mel), jnp.asarray(LENGTHS), n=2,
        scene=scene, deterministic=True,
        method=enc.get_intermediate_layers))


def _port(params, fused):
    enc = tatst.frame_ast_tiny(spec_w=SPEC_W, fused=fused,
                               dtype=torch.float32, device="cpu")
    enc.load_state_dict(state_dict_from_flax(params))
    return enc


@pytest.mark.parametrize("scene", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_get_intermediate_layers_matches_jax(frame_tiny, fused, scene):
    enc, params, mel = frame_tiny
    want = _jax_layers(enc, params, mel, scene)
    with torch.no_grad():
        got = _port(params, fused).get_intermediate_layers(
            torch.from_numpy(mel), torch.from_numpy(LENGTHS), n=2,
            scene=scene).numpy()
    assert got.shape == want.shape
    for i, plen in enumerate(LENGTHS // 4):
        if scene:  # masked token mean: 0 for plen = 0 on both sides
            np.testing.assert_allclose(got[i], want[i], atol=2e-4)
        elif fused:
            np.testing.assert_allclose(got[i, :plen], want[i, :plen],
                                       atol=2e-4)
        else:
            np.testing.assert_allclose(
                got[i], want[i], atol=2e-4 if plen else ZERO_VALID_ATOL)


def test_state_dict_from_flax_round_trips(frame_tiny):
    _, params, _ = frame_tiny
    sd = state_dict_from_flax(params)
    assert "blocks.0.attn.qkv.bias" not in sd  # qkv_bias=False arch
    back = encoder_params_from_torch(sd)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(k))
    # and the port's modules take the state dict as it is
    tatst.frame_ast_tiny(spec_w=SPEC_W, device="cpu").load_state_dict(sd)


@pytest.mark.parametrize("fn", ["patchify", "patch_lengths", "masks", "gelu"])
def test_helpers_match_jax(fn):
    rng = np.random.RandomState(1)
    if fn == "patchify":
        mel = rng.randn(2, 64, 43).astype(np.float32)
        np.testing.assert_array_equal(
            tatst.patchify(torch.from_numpy(mel), 64, 4).numpy(),
            np.asarray(jatst.patchify(jnp.asarray(mel), 64, 4)))
    elif fn == "patch_lengths":
        n = np.asarray([0, 3, 4, 1001], np.int32)
        np.testing.assert_array_equal(
            tatst.patch_lengths(torch.from_numpy(n), 64, 64, 4).numpy(),
            np.asarray(jatst.patch_lengths(jnp.asarray(n), 64, 64, 4)))
    elif fn == "masks":
        n = np.asarray([0, 5, 9], np.int32)
        np.testing.assert_array_equal(
            ttr.length_to_attn_mask(torch.from_numpy(n), 9).numpy(),
            np.asarray(jtr.length_to_attn_mask(jnp.asarray(n), 9)))
        np.testing.assert_array_equal(
            ttr.length_to_token_mask(torch.from_numpy(n), 9).numpy(),
            np.asarray(jtr.length_to_token_mask(jnp.asarray(n), 9)))
    else:
        x = (rng.randn(4096) * 3).astype(np.float32)
        np.testing.assert_allclose(
            ttr.gelu_exact(torch.from_numpy(x)).numpy(),
            np.asarray(jtr.gelu_exact(jnp.asarray(x))), atol=1e-6)


# ------------------------------------------------------------------ #
# drop path on the downstream APIs
# ------------------------------------------------------------------ #
def _jitter(params, rng):
    return jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)


DP_RATE, DP_DEPTH = 0.4, 3


# api: (the encoder has a CLS token, the method, its arguments, the
# sequences per clip)
DP_APIS = {
    "clip_chunks": (True, "get_intermediate_layers_chunks",
                    dict(n=2, chunk_len=101), 2),
    "clip_cls_avg": (True, "cls_avg_layers", dict(n=2), 1),
    "clip_scene": (True, "get_intermediate_layers", dict(n=2, scene=True), 1),
    "frame_scene": (False, "get_intermediate_layers", dict(n=2, scene=True),
                    1),
    "frame_frames": (False, "get_intermediate_layers",
                     dict(n=2, scene=False), 1),
}


@pytest.mark.parametrize("api", sorted(DP_APIS))
def test_downstream_drop_path_matches_jax(monkeypatch, api):
    """The training form of the downstream APIs (the chunked clip API with
    its B * chunks rows, ``cls_avg_layers``, the scene and frame
    embeddings), 3 blocks at drop-path rate 0.4 (block i at 0.4 i / 2),
    against JAX's with its ``drop_path`` (``models/transformer.py:160``)
    handed the same uniforms. Output and every parameter's gradient of
    its sum, atol 1e-5 and 1e-4: nothing on the way detaches."""
    use_cls, method, chunk, per_clip = DP_APIS[api]
    rng = np.random.RandomState(4)
    W = 101
    mel = rng.randn(3, 64, 180).astype(np.float32)
    lengths = np.asarray([180, 120, 40], np.int32)
    kw = dict(embed_dim=64, depth=DP_DEPTH, num_heads=2, use_cls=use_cls,
              spec_w=W)
    enc = jatst.AudioTransformer(drop_path_rate=DP_RATE, **kw)
    chunked = method == "get_intermediate_layers_chunks"
    mel_in = mel if chunked else mel[:, :, :W]
    len_in = lengths if chunked else np.minimum(lengths, W)
    params = _jitter(enc.init(jax.random.PRNGKey(2),
                              jnp.zeros((1, 64, W), jnp.float32),
                              deterministic=True)["params"], rng)

    calls = []
    keys = iter(np.asarray(jax.random.split(jax.random.PRNGKey(6), 16)))
    jax_drop_path = jtr.drop_path

    def drop_path(x, rate, deterministic, key):
        k = next(keys)
        calls.append((rate, k, (x.shape[0],) + (1,) * (x.ndim - 1)))
        return jax_drop_path(x, rate, deterministic, k)

    monkeypatch.setattr(jtr, "drop_path", drop_path)

    def total(out):  # cls_avg_layers gives (cls, avg)
        return (out[0].sum() + out[1].sum() if isinstance(out, tuple)
                else out.sum())

    def loss(p):
        out = enc.apply({"params": p}, jnp.asarray(mel_in),
                        jnp.asarray(len_in), deterministic=False,
                        rngs={"droppath": jax.random.PRNGKey(0)},
                        method=getattr(enc, method), **chunk)
        return total(out), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    # block 0 has rate 0 and draws nothing; blocks 1, 2 draw for the
    # attention, then the MLP branch
    rows = calls[0][2][0]
    assert rows == 3 * per_clip
    u = np.zeros((DP_DEPTH, 2, rows), np.float32)
    for j, (rate, k, shape) in enumerate(calls):
        i, branch = 1 + j // 2, j % 2
        assert rate == pytest.approx(DP_RATE * i / (DP_DEPTH - 1))
        u[i, branch] = np.asarray(jax.random.uniform(k, shape)).reshape(-1)
    assert len(calls) == 2 * (DP_DEPTH - 1)
    dps = ttr.drop_path_multipliers(torch.from_numpy(u), DP_RATE)
    assert float((dps == 0).float().sum()) > 0  # some rows dropped

    port = tatst.AudioTransformer(device="cpu", **kw)
    port.load_state_dict(state_dict_from_flax(params))
    got = getattr(port, method)(torch.from_numpy(mel_in),
                                torch.from_numpy(len_in).long(), dps=dps,
                                **chunk)
    total(got).backward()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5)
    jsd = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in port.named_parameters():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        np.testing.assert_allclose(g, jsd[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_reference_prompt_embed_is_left_out():
    """``load_encoder_state`` leaves a reference state dict's
    ``prompt_embed`` out of a port frame encoder built without prompt
    tokens, as flax leaves an unused param alone, and loads the
    rest."""
    src = tatst.frame_ast_tiny(spec_w=SPEC_W, device="cpu",
                               generator=torch.Generator().manual_seed(5))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.prompt_embed"] = torch.randn(1, 2, 64)
    got = tatst.frame_ast_tiny(spec_w=SPEC_W, device="cpu")
    load_encoder_state(got, strip_prefixes(sd))
    assert not hasattr(got, "prompt_embed")
    for k, v in src.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
