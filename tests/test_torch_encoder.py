"""The port's frame encoder against the JAX ``AudioTransformer`` (CPU, f32).

Frame-tiny (C=64, 2 blocks, 2 heads) on weights carried over by
``state_dict_from_flax``, with ragged lengths including a sample whose
patch count is 0. The module path (``fused=False``) is compared on all
tokens; the block-kernel path (``fused=True`` built in f32, whose
kernel wrappers take their plain versions on the CPU) on the valid
tokens, since it masks keys by validity columns instead of the additive
-10000 mask. Tolerance 2e-4, except on the module path's sample with no
valid token (see ``ZERO_VALID_ATOL``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.compat.torch_import import encoder_params_from_torch  # noqa: E402
from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models import transformer as jtr  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import state_dict_from_flax  # noqa: E402
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
