"""The int8 quantization helpers of the port (``ops/quant.py``) against the
JAX package's (``audiossl_tpu/ops/pallas_block.py``): weight codes and
scales, per-row activation codes and scales with and without a bound, and
the dequantized int8 product. All bit-equal: both sides round the same f32
values half to even, and both products are exact before their one
rounding to f32.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import pallas_block as jpb  # noqa: E402
from audiossl_tpu_torch.ops import quant as tq  # noqa: E402


def _w(rng, k, j):
    w = (rng.randn(k, j) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel: its scale clamps to 1e-30
    return w


@pytest.mark.parametrize("layout", ["out_channel", "in_channel"])
def test_quantize_weight_q8_bit_equal(layout):
    """Per-output-channel codes of torch's [out, in] weight are JAX's
    codes of its [in, out] kernel, transposed; per-input-channel codes
    (``dim=0``, the int8dx backward) are JAX's codes of the transpose."""
    rng = np.random.RandomState(0)
    wj = _w(rng, 48, 80)  # the JAX kernel [in, out]
    if layout == "out_channel":
        jq, js = jpb.quantize_weight_q8(jnp.asarray(wj))
        q, s = tq.quantize_weight_q8(torch.from_numpy(wj.T.copy()))
        q = q.t()
    else:
        jq, js = jpb.quantize_weight_q8(jnp.asarray(wj.T))
        q, s = tq.quantize_weight_q8(torch.from_numpy(wj.T.copy()), dim=0)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])
    assert int(np.abs(np.asarray(jq)).max()) == 127


def test_dequantized_weight_matches_jax():
    rng = np.random.RandomState(1)
    wj = _w(rng, 32, 64)
    jq, js = jpb.quantize_weight_q8(jnp.asarray(wj))
    want = (jq.astype(jnp.float32) * js).astype(jnp.bfloat16)
    q, s = tq.quantize_weight_q8(torch.from_numpy(wj.T.copy()))
    got = tq.dequantize_weight_q8(q, s, torch.bfloat16)
    np.testing.assert_array_equal(got.t().float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("bound", [False, True])
def test_q8_act_bit_equal(bound):
    """Codes and scales of f32 rows, with a zero row, rows whose scaled
    values land on halves (round half to even) and, with a bound, codes
    that the clamp holds at 127."""
    rng = np.random.RandomState(2)
    h = (rng.randn(6, 96) * 3.0).astype(np.float32)
    h[1] = 0.0
    h[2, :5] = [127.0, 0.5, 1.5, 2.5, -2.5]
    h[2, 5:] = 0.0
    b = None
    if bound:
        b = np.abs(h).max(axis=1, keepdims=True) * np.asarray(
            [[1.0], [1.0], [1.0], [0.5], [2.0], [1.0]], np.float32)
    jq, jr = jpb._q8_act(jnp.asarray(h),
                         None if b is None else jnp.asarray(b))
    q, r = tq.q8_act(torch.from_numpy(h),
                     None if b is None else torch.from_numpy(b))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(q[2, :5].numpy(), [127, 0, 2, 2, -2])
    if bound:
        assert int(q[3].abs().max()) == 127  # clamped: the bound is low


@pytest.mark.parametrize("K", [64, 3072])
def test_q8_dot_bit_equal_and_exact(K):
    """The dequantized product matches ``_q8_dot`` bit for bit, at fc2's
    depth K = 3,072 too, where an f32 sum of int8 products is no longer
    exact; the plain product is the exact integer product."""
    rng = np.random.RandomState(3)
    h = (rng.randn(20, K) * 2.0).astype(np.float32)
    wj = _w(rng, K, 48)
    jq, js = jpb.quantize_weight_q8(jnp.asarray(wj))
    want = jpb._q8_dot(jnp.asarray(h), jq, js)
    q, s = tq.quantize_weight_q8(torch.from_numpy(wj.T.copy()))
    got = tq.q8_dot(torch.from_numpy(h), q.t(), s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hq, _ = tq.q8_act(torch.from_numpy(h))
    exact = hq.long() @ q.t().long()
    np.testing.assert_array_equal(tq.int8_matmul(hq, q.t()).numpy(),
                                  exact.float().numpy())


def test_check_quant():
    assert tq.check_quant("none") is None and tq.check_quant(None) is None
    assert tq.check_quant("int8dx") == "int8dx"
    with pytest.raises(ValueError, match="unknown quant mode"):
        tq.check_quant("int8dx", ("int8",))
    with pytest.raises(ValueError, match="unknown quant mode"):
        tq.check_quant("fp8")
