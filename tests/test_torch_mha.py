"""Plain version of the standalone MHA kernel K6 against the JAX Pallas
kernel ``audiossl_tpu/ops/pallas_mha.py:fused_mha`` run in interpret mode
on the CPU.

B=4 sequences, N in {151, 128}, C=128, 2 heads of 64, with the additive
key mask of valid lengths [N, N - 30, 9, 0] (the last sequence has no valid
key). The forward and the qkv gradient of sum(sin(out)) are held to rel L2
1e-5 in f32 and 1e-2 in bf16 (the same rounding points; f32 sums in
another order can move a bf16 element by one step); the sequence with no
valid key gives 0 and a finite zero gradient on both sides.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import pallas_mha as jmha  # noqa: E402
from audiossl_tpu_torch.ops import mha as tmha  # noqa: E402

B, C, H = 4, 128, 2
SCALE = (C // H) ** -0.5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, n, 3 * C).astype(np.float32)
    lengths = np.asarray([n, n - 30, 9, 0])
    mask = np.where(np.arange(n)[None, :] < lengths[:, None], 0.0,
                    -10000.0).astype(np.float32)
    return qkv, mask


def _jax(qkv, mask, dtype):
    x = jnp.asarray(qkv, dtype)
    m = jnp.asarray(mask)

    def loss(x):
        out = jmha.fused_mha(x, m, H, SCALE, True)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    out = jmha.fused_mha(x, m, H, SCALE, True)
    g = jax.grad(loss)(x)
    return np.asarray(out, np.float32), np.asarray(g, np.float32)


def _port(qkv, mask, dtype):
    x = torch.tensor(qkv).to(dtype).requires_grad_()
    out = tmha.fused_mha(x, torch.tensor(mask), H, SCALE)
    torch.sin(out.float()).sum().backward()
    return out.detach().float().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("n", [151, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mha_plain_matches_pallas(n, dtype):
    qkv, mask = _inputs(n, seed=n)
    want_o, want_g = _jax(qkv, mask, getattr(jnp, dtype))
    got_o, got_g = _port(qkv, mask, getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert got_o.shape == (B, n, C) and got_g.shape == (B, n, 3 * C)
    assert _rel(got_o, want_o) <= tol
    assert _rel(got_g, want_g) <= tol
    # the sequence with no valid key: output and gradient 0, finite
    for a in (got_o, got_g, want_o, want_g):
        assert np.all(np.isfinite(a))
        assert not np.any(a[3])


def test_fused_mha_rejects_long_sequences():
    n = tmha.MAX_SEQ + 1
    with pytest.raises(ValueError, match="N=1537"):
        tmha.fused_mha(torch.zeros(1, n, 3 * C), torch.zeros(1, n), H, SCALE)


def test_fused_mha_is_the_module_softmax_where_a_key_is_valid():
    """On sequences with a valid key, K6's exp-only attention is the module
    path's softmax attention with the -10000 mask."""
    qkv, mask = _inputs(40, seed=3)
    x = torch.tensor(qkv)
    got = tmha.fused_mha(x, torch.tensor(mask), H, SCALE)
    q, k, v = x.reshape(B, 40, 3, H, C // H).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * SCALE
    p = (s + torch.tensor(mask)[:, None, None, :]).softmax(dim=-1)
    want = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(B, 40, C)
    np.testing.assert_allclose(got[:3].numpy(), want[:3].numpy(), atol=2e-6)
