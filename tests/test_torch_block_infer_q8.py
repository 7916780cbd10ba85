"""Plain versions of the int8 inference block kernels K2q/K3q against the
JAX Pallas kernels (``pallas_block.py`` with ``quant="int8"``) run in
interpret mode on the CPU.

C=64, 2 heads, N=128 tokens (so the JAX side pads nothing and a sequence
with no valid key attends over the same keys on both sides), bf16
activations, ragged valid rows including one with no valid key,
drop-path multipliers in {0, 1, 1/keep}. Both sides quantize the same f32
values and take exact int8 products; their f32 sums elsewhere (LN
statistics, attention) run in another order, which can flip a rare int8
code or move an element by one bf16 step: rel L2 <= 2e-3 and >= 99% of the
bf16 elements equal. The int8-vs-float budget is JAX's 2e-2
(``tests/test_pallas_kernels.py:479-564``).
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
from audiossl_tpu_torch.ops.quant import quantize_weight_q8  # noqa: E402

C, H, N, EPS = 64, 2, 128, 1e-6
LENGTHS = np.asarray([128, 77, 0, 5], np.int32)
DP = np.asarray([1.0, 0.0, 1.0 / 0.9, 1.0], np.float32)
REL_L2, EQUAL = 2e-3, 0.99


def _block_params(rng):
    def n(*shape, s=0.1):
        return (rng.randn(*shape) * s).astype(np.float32)

    return {
        "norm1": {"scale": 1.0 + n(C), "bias": n(C)},
        "norm2": {"scale": 1.0 + n(C), "bias": n(C)},
        "attn": {"qkv": {"kernel": n(C, 3 * C), "bias": n(3 * C)},
                 "proj": {"kernel": n(C, C), "bias": n(C)}},
        "mlp": {"fc1": {"kernel": n(C, 4 * C), "bias": n(4 * C)},
                "fc2": {"kernel": n(4 * C, C), "bias": n(C)}},
    }


def _inputs(seed):
    rng = np.random.RandomState(seed)
    p = _block_params(rng)
    x = rng.randn(len(LENGTHS), N, C).astype(np.float32)
    valid = (np.arange(N)[None, :] < LENGTHS[:, None]).astype(np.float32)
    return p, x, valid


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _q(kernel):  # the JAX [in, out] kernel's codes in torch's layout
    return quantize_weight_q8(_t(kernel.T))


def _attn_q8_args(p):
    return (_t(p["norm1"]["scale"]), _t(p["norm1"]["bias"]),
            *_q(p["attn"]["qkv"]["kernel"]), _t(p["attn"]["qkv"]["bias"]),
            *_q(p["attn"]["proj"]["kernel"]), _t(p["attn"]["proj"]["bias"]))


def _mlp_q8_args(p):
    return (_t(p["norm2"]["scale"]), _t(p["norm2"]["bias"]),
            *_q(p["mlp"]["fc1"]["kernel"]), _t(p["mlp"]["fc1"]["bias"]),
            *_q(p["mlp"]["fc2"]["kernel"]), _t(p["mlp"]["fc2"]["bias"]))


def _close(got, want, rel_max=REL_L2, equal=EQUAL):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= rel_max, rel
    assert np.mean(got == want) >= equal, np.mean(got == want)


def _jax_half(half, p, x, valid, quant):
    xb = jnp.asarray(x, jnp.bfloat16)
    if half == "attn":
        return jpb.attn_block_infer(xb, jnp.asarray(valid), p, H, eps=EPS,
                                    dp=jnp.asarray(DP), quant=quant,
                                    interpret=True)
    return jpb.mlp_block_infer(xb, p, eps=EPS, dp=jnp.asarray(DP),
                               quant=quant, interpret=True)


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_block_infer_q8_ref_matches_pallas(half):
    p, x, valid = _inputs(0 if half == "attn" else 1)
    want = _jax_half(half, p, x, valid, "int8")
    xb = _t(x, torch.bfloat16)
    if half == "attn":
        got = tbi.attn_block_infer_q8(xb, _t(valid), *_attn_q8_args(p), H,
                                      EPS, dp=_t(DP))
    else:
        got = tbi.mlp_block_infer_q8(xb, *_mlp_q8_args(p), EPS, dp=_t(DP))
    assert got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("plain", [False, True])
def test_encoder_blocks_infer_quant_quantizes_the_weights(plain):
    """``encoder_blocks_infer(quant="int8")`` quantizes each block's f32
    weights per output channel on every call and strings K2q and K3q (their
    plain versions on the CPU tensor, or with ``plain``): bit for bit the
    q8 entry points on the codes of ``quantize_weight_q8``, drop-path
    multipliers included."""
    p, x, valid = _inputs(2)
    holder = nn.Module()
    holder.blocks = nn.ModuleList([Block(C, H, qkv_bias=True, eps=EPS)])
    holder.load_state_dict(state_dict_from_flax({"blocks_0": p}))
    dps = _t(np.stack([DP, DP[::-1]]))[None]  # [depth, 2, B]
    with torch.no_grad():
        got, _ = tbi.encoder_blocks_infer(
            holder.blocks, _t(x), torch.from_numpy(LENGTHS), H, EPS,
            dps=dps, dtype=torch.bfloat16, plain=plain, quant="int8")
        want = tbi.attn_block_infer_q8_ref(
            _t(x, torch.bfloat16), _t(valid), *_attn_q8_args(p), H, EPS,
            dp=dps[0, 0])
        want = tbi.mlp_block_infer_q8_ref(want, *_mlp_q8_args(p), EPS,
                                          dp=dps[0, 1])
    assert torch.equal(got, want)


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_block_infer_q8_tracks_float(half):
    """The port's int8 halves stay within JAX's int8-vs-float budget of the
    bf16 halves, and so do JAX's own at the same inputs."""
    p, x, valid = _inputs(3)
    jq = np.asarray(_jax_half(half, p, x, valid, "int8"), np.float32)
    jf = np.asarray(_jax_half(half, p, x, valid, None), np.float32)
    xb = _t(x, torch.bfloat16)
    if half == "attn":
        got = tbi.attn_block_infer_q8(xb, _t(valid), *_attn_q8_args(p), H,
                                      EPS, dp=_t(DP)).float().numpy()
    else:
        got = tbi.mlp_block_infer_q8(xb, *_mlp_q8_args(p), EPS,
                                     dp=_t(DP)).float().numpy()
    # the residual branch alone: x itself dominates the block's output
    for out in (got, jq):
        rel = (np.linalg.norm((out - x) - (jf - x))
               / np.linalg.norm(jf - x))
        assert rel < 2e-2, rel


def test_encoder_blocks_infer_q8_matches_pallas():
    """Two blocks strung by ``encoder_blocks_infer(quant="int8")``: each
    block's weights quantized from the f32 weights on every call. The
    bf16 residual stream carries the first block's one-step differences
    into the second, whose output then lands ~2e-3 apart (rel L2) with
    ~70% of the elements equal on the float path as well: 5e-3 here."""
    rng = np.random.RandomState(4)
    params = {f"blocks_{i}": _block_params(rng) for i in range(2)}
    x = rng.randn(len(LENGTHS), N, C).astype(np.float32)
    want, wcol = jpb.encoder_blocks_infer(
        params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(LENGTHS), H, 2,
        eps=EPS, collect_from=0, quant="int8", interpret=True)
    holder = nn.Module()
    holder.blocks = nn.ModuleList(
        Block(C, H, qkv_bias=True, eps=EPS) for _ in range(2))
    holder.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got, col = tbi.encoder_blocks_infer(
            holder.blocks, _t(x), torch.from_numpy(LENGTHS), H, EPS,
            collect_from=0, dtype=torch.bfloat16, quant="int8")
    assert len(col) == len(wcol) == 2
    _close(col[0], wcol[0])
    _close(got, want, rel_max=5e-3, equal=0.5)
    _close(col[1], wcol[1], rel_max=5e-3, equal=0.5)
