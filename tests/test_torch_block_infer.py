"""Plain versions of the block kernels K2/K3 against the JAX Pallas kernels
(``audiossl_tpu/ops/pallas_block.py``) run in interpret mode on the CPU.

Small widths (C=64, 2 heads), ragged valid rows including one with no
valid key, drop-path multipliers in {0, 1, 1/keep}. f32 tolerance 2e-4
as in ``tests/test_pallas_kernels.py``; the bf16 case checks that the
plain version rounds where the TPU kernel rounds.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from audiossl_tpu.ops import pallas_block as jpb  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import state_dict_from_flax  # noqa: E402
from audiossl_tpu_torch.models.transformer import Block  # noqa: E402
from audiossl_tpu_torch.ops import block_infer as tbi  # noqa: E402

C, H, EPS = 64, 2, 1e-6
DP = np.asarray([1.0, 0.0, 1.0 / 0.9, 1.0], np.float32)


def _block_params(rng, qkv_bias=False):
    def n(*shape, s=0.1):
        return (rng.randn(*shape) * s).astype(np.float32)

    p = {
        "norm1": {"scale": 1.0 + n(C), "bias": n(C)},
        "norm2": {"scale": 1.0 + n(C), "bias": n(C)},
        "attn": {"qkv": {"kernel": n(C, 3 * C)},
                 "proj": {"kernel": n(C, C), "bias": n(C)}},
        "mlp": {"fc1": {"kernel": n(C, 4 * C), "bias": n(4 * C)},
                "fc2": {"kernel": n(4 * C, C), "bias": n(C)}},
    }
    if qkv_bias:
        p["attn"]["qkv"]["bias"] = n(3 * C)
    return p


def _inputs(rng, N, lengths):
    x = rng.randn(len(lengths), N, C).astype(np.float32)
    valid = (np.arange(N)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    return x, valid


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _attn_args(p, dtype=torch.float32):
    bq = p["attn"]["qkv"].get("bias")
    return (_t(p["norm1"]["scale"]), _t(p["norm1"]["bias"]),
            _t(p["attn"]["qkv"]["kernel"].T, dtype),
            None if bq is None else _t(bq),
            _t(p["attn"]["proj"]["kernel"].T, dtype),
            _t(p["attn"]["proj"]["bias"]))


def _mlp_args(p, dtype=torch.float32):
    return (_t(p["norm2"]["scale"]), _t(p["norm2"]["bias"]),
            _t(p["mlp"]["fc1"]["kernel"].T, dtype), _t(p["mlp"]["fc1"]["bias"]),
            _t(p["mlp"]["fc2"]["kernel"].T, dtype), _t(p["mlp"]["fc2"]["bias"]))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attn_block_infer_ref_matches_pallas(qkv_bias):
    rng = np.random.RandomState(0)
    p = _block_params(rng, qkv_bias)
    x, valid = _inputs(rng, 24, [24, 13, 0, 7])
    want = jpb.attn_block_infer(jnp.asarray(x), jnp.asarray(valid), p, H,
                                eps=EPS, dp=jnp.asarray(DP), interpret=True)
    got = tbi.attn_block_infer(_t(x), _t(valid), *_attn_args(p), H, EPS,
                               dp=_t(DP))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_mlp_block_infer_ref_matches_pallas():
    rng = np.random.RandomState(1)
    p = _block_params(rng)
    x, _ = _inputs(rng, 24, [24, 13, 0, 7])
    want = jpb.mlp_block_infer(jnp.asarray(x), p, eps=EPS,
                               dp=jnp.asarray(DP), interpret=True)
    got = tbi.mlp_block_infer(_t(x), *_mlp_args(p), EPS, dp=_t(DP))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_block_infer_ref_bf16_rounding_points(half):
    """bf16 activations: the plain version rounds qkv, exp(s), the
    attention output and the GELU output where the Pallas kernel does.
    Both sides accumulate in f32 in their own order, so an element may
    land one bf16 step (2^-8 relative) apart. Dropping either the qkv or
    the exp(s) rounding moves about a tenth of the elements and the
    relative L2 error to ~1e-3, which these bounds reject."""
    rng = np.random.RandomState(2)
    p = _block_params(rng, qkv_bias=True)
    x, valid = _inputs(rng, 24, [24, 13, 0, 7])
    xb = jnp.asarray(x, jnp.bfloat16)
    if half == "attn":
        want = jpb.attn_block_infer(xb, jnp.asarray(valid), p, H, eps=EPS,
                                    dp=jnp.asarray(DP), interpret=True)
        got = tbi.attn_block_infer(_t(x, torch.bfloat16), _t(valid),
                                   *_attn_args(p, torch.bfloat16), H, EPS,
                                   dp=_t(DP))
    else:
        want = jpb.mlp_block_infer(xb, p, eps=EPS, dp=jnp.asarray(DP),
                                   interpret=True)
        got = tbi.mlp_block_infer(_t(x, torch.bfloat16),
                                  *_mlp_args(p, torch.bfloat16), EPS,
                                  dp=_t(DP))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 3e-4, rel
    assert np.mean(got == want) > 0.97


def test_encoder_blocks_infer_matches_pallas():
    """Two blocks strung by ``encoder_blocks_infer``. N = 128 so the JAX
    version pads nothing, and the row with no valid token attends over
    the same keys on both sides."""
    rng = np.random.RandomState(3)
    params = {f"blocks_{i}": _block_params(rng) for i in range(2)}
    lengths = np.asarray([128, 77, 0, 5], np.int32)
    x, _ = _inputs(rng, 128, lengths)
    want, wcol = jpb.encoder_blocks_infer(
        params, jnp.asarray(x), jnp.asarray(lengths), H, 2, eps=EPS,
        collect_from=0, interpret=True)
    holder = nn.Module()
    holder.blocks = nn.ModuleList(Block(C, H, eps=EPS) for _ in range(2))
    holder.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got, col = tbi.encoder_blocks_infer(holder.blocks, _t(x),
                                            torch.from_numpy(lengths), H,
                                            EPS, collect_from=0)
    assert len(col) == len(wcol) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    for c, w in zip(col, wcol):
        np.testing.assert_allclose(c.numpy(), np.asarray(w), atol=2e-4)
