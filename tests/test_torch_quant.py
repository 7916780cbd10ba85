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


def test_transposed_codes_bit_equal():
    """The int8dx products read the codes of W^T ([in, out], K-major):
    quantizing the transposed weight per its output channels gives the
    per-input-channel codes of W transposed, with the same scales, and
    JAX's ``quantize_weight_q8(w.T)`` transposed."""
    rng = np.random.RandomState(4)
    wj = _w(rng, 48, 80)  # the JAX kernel [in, out]
    w = torch.from_numpy(wj.T.copy())  # torch's [out, in]
    q, s = tq.quantize_weight_q8(w.t().contiguous())
    q0, s0 = tq.quantize_weight_q8(w, dim=0)
    jq, js = jpb.quantize_weight_q8(jnp.asarray(wj.T))
    assert tuple(q.shape) == (48, 80) and tuple(s.shape) == (48,)
    assert torch.equal(q, q0.t()) and torch.equal(s, s0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])


@pytest.mark.parametrize("which", ["mlp_train_bwd_q8dx",
                                   "attn_train_bwd_q8dx"])
def test_int8dx_launchers_take_the_codes_of_w_transposed(which,
                                                         monkeypatch):
    """The int8dx backward wrappers keep their interface (codes of W per
    input channel, W's layout) and hand the launcher the codes of W^T,
    [in, out] and contiguous, so that its int8 products read them
    K-major. Meta activations reach the kernel path; the launch is
    captured instead of run."""
    from audiossl_tpu_torch.kernels import build as kb
    from audiossl_tpu_torch.ops import attn_train, mlp_train

    launched = []
    monkeypatch.setattr(kb, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kb, "ptr", lambda t: t)
    monkeypatch.setattr(kb, "launch",
                        lambda name, dev, *args: launched.append(args))
    meta, bf = torch.device("meta"), torch.bfloat16
    C, Hd = 64, 256

    def t(*shape, dtype=torch.float32):
        return torch.empty(*shape, device=meta, dtype=dtype)

    rng = np.random.RandomState(5)
    if which == "mlp_train_bwd_q8dx":
        w1, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                  for s in ((Hd, C), (C, Hd)))
        (wt1, st1), (wt2, st2) = (tq.quantize_weight_q8(w, dim=0)
                                  for w in (w1, w2))
        mlp_train.mlp_train_bwd_q8dx(
            t(2, 8, C, dtype=bf), t(2, 8, C, dtype=bf), t(2, 8, Hd, dtype=bf),
            t(2), t(C), t(C), wt1, st1, wt2, st2)
        want = {6: (w1, (C, Hd)), 8: (w2, (Hd, C))}
    else:
        w_qkv, w_proj = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                         for s in ((3 * C, C), (C, C)))
        (wt_qkv, st_qkv), (wt_proj, st_proj) = (
            tq.quantize_weight_q8(w, dim=0) for w in (w_qkv, w_proj))
        attn_train.attn_train_bwd_q8dx(
            t(2, 8, C, dtype=bf), t(2, 8, C, dtype=bf),
            t(2, 8, 3 * C, dtype=bf), t(2, 8, C, dtype=bf), t(2, 8, 2),
            t(2, 8), t(2), t(C), t(C), wt_qkv, st_qkv, wt_proj, st_proj, 2)
        want = {9: (w_qkv, (C, 3 * C)), 11: (w_proj, (C, C))}
    (args,) = launched
    for i, (w, shape) in want.items():
        codes, scales = tq.quantize_weight_q8(w.t().contiguous())
        assert tuple(args[i].shape) == shape and args[i].is_contiguous()
        assert args[i].dtype == torch.int8
        assert torch.equal(args[i], codes)
        assert torch.equal(args[i + 1], scales)
