"""Plain version of the standalone MHA kernel K6 against the JAX Pallas
kernel ``audiossl_tpu/ops/pallas_mha.py:fused_mha`` run in interpret mode
on the CPU.

B=4 sequences, N in {151, 128, 17}, C=128, 2 heads of 64 or 4 heads of 32
(the kernel's two head-dim instantiations), with the additive key mask of
valid lengths [N, N - 30 (N // 2 for N = 17), 9, 0] (the last sequence has
no valid key). The forward and the qkv gradient of sum(sin(out)) are held to
rel L2 1e-5 in f32 and 1e-2 in bf16 (the same rounding points; f32 sums in
another order can move a bf16 element by one step); the sequence with no
valid key gives 0 and a finite zero gradient on both sides.

On the card the f32 forward and backward form each product in 3xTF32
(each operand split into two TF32 halves, three tensor-core passes); an
emulation of that split here documents its error against f32.
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
    lengths = np.asarray([n, n - 30 if n > 30 else n // 2, 9, 0])
    mask = np.where(np.arange(n)[None, :] < lengths[:, None], 0.0,
                    -10000.0).astype(np.float32)
    return qkv, mask


def _jax(qkv, mask, dtype, heads=H):
    x = jnp.asarray(qkv, dtype)
    m = jnp.asarray(mask)
    scale = (C // heads) ** -0.5

    def loss(x):
        out = jmha.fused_mha(x, m, heads, scale, True)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    out = jmha.fused_mha(x, m, heads, scale, True)
    g = jax.grad(loss)(x)
    return np.asarray(out, np.float32), np.asarray(g, np.float32)


def _port(qkv, mask, dtype, heads=H):
    x = torch.tensor(qkv).to(dtype).requires_grad_()
    out = tmha.fused_mha(x, torch.tensor(mask), heads, (C // heads) ** -0.5)
    torch.sin(out.float()).sum().backward()
    return out.detach().float().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("n,heads", [
    pytest.param(n, h, id=f"{n}" if h == 2 else f"{n}-d32")
    for h in (2, 4) for n in (151, 128, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mha_plain_matches_pallas(n, heads, dtype):
    qkv, mask = _inputs(n, seed=n + heads - 2)
    want_o, want_g = _jax(qkv, mask, getattr(jnp, dtype), heads)
    got_o, got_g = _port(qkv, mask, getattr(torch, dtype), heads)
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
    # and scaled_dot_product_attention with the boolean key mask: K6's
    # library call on the card (chip_smoke.py times it beside the kernel)
    keep = torch.tensor(mask > -1.0)[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q[:3].transpose(1, 2), k[:3].transpose(1, 2), v[:3].transpose(1, 2),
        attn_mask=keep[:3], scale=SCALE)
    np.testing.assert_allclose(
        got[:3].numpy(), sdpa.transpose(1, 2).reshape(3, 40, C).numpy(),
        atol=2e-6)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to the
    magnitude, then mask them off."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _einsum_tf32(passes):
    """einsum of f32 operands on emulated TF32 tensor cores: one pass
    (hi hi) or 3xTF32 (lo hi + hi lo + hi hi, hi = tf32(x), lo =
    tf32(x - hi)), each pass an f32 einsum of the split operands."""
    def ein(spec, a, b):
        ah, bh = _tf32(a), _tf32(b)
        if passes == 1:
            return torch.einsum(spec, ah, bh)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)
                + torch.einsum(spec, ah, bh))
    return ein


def _bwd_emulated(qkv, o, r, do, valid, heads, scale, ein):
    """The f32 backward of the core with its five products (S, dpd, dq, dk,
    dv) through ``ein``; every other step as ``exp_attention_bwd_ref``."""
    Bq, n, C3 = qkv.shape
    d = C3 // 3 // heads
    vk = valid.float()[:, :, None, None]
    q, k, v = qkv.reshape(Bq, n, 3, heads, d).unbind(2)
    kz, vz = k * vk, v * vk
    rr = r[..., None]
    dog = do.reshape(Bq, n, heads, d)
    delta = (dog * o.reshape(Bq, n, heads, d)).sum(dim=-1, keepdim=True)
    dor = dog * rr
    nd = (-delta * rr).squeeze(-1).permute(0, 2, 1)[..., None]
    e = torch.exp(ein("bnhd,bmhd->bhnm", q, kz) * scale)
    t = e * (ein("bnhd,bmhd->bhnm", dor, vz) + nd)
    dq = ein("bhnm,bmhd->bnhd", t, kz) * scale
    dk = ein("bhnm,bnhd->bmhd", t, q) * scale
    dv = ein("bhnm,bnhd->bmhd", e, dor)
    return torch.stack([dq, dk * vk, dv * vk], dim=2).reshape(Bq, n, C3)


@pytest.mark.parametrize("heads", [2, 4])
def test_3xtf32_backward_stays_at_f32_accuracy(heads):
    """The f32 backward's design on the card: its five products in 3xTF32
    stay within 1e-6 rel L2 of the f32 plain version, far inside the card
    check's 1e-4 (chip_smoke.MHA_F32_REL); one TF32 pass would not (~1e-3)."""
    qkv, mask = _inputs(97, seed=5)
    x = torch.tensor(qkv)
    valid = torch.tensor(mask > -1.0).float()
    g = torch.tensor(np.random.RandomState(6).randn(B, 97, C).astype(
        np.float32))
    scale = (C // heads) ** -0.5
    o, r = tmha.mha_fwd_ref(x, valid, heads, scale)
    want = tmha.mha_bwd_ref(x, valid, o, r, g, heads, scale)
    three = _bwd_emulated(x, o, r, g, valid, heads, scale, _einsum_tf32(3))
    one = _bwd_emulated(x, o, r, g, valid, heads, scale, _einsum_tf32(1))
    assert _rel(three.numpy(), want.numpy()) <= 1e-6
    assert _rel(one.numpy(), want.numpy()) >= 1e-4
    assert not three[3].any()  # no valid key: zero gradient


def _fwd_emulated(qkv, valid, heads, scale, ein):
    """The f32 forward of the core with its two products (S = q kz^T and
    e vz) through ``ein``, its denominator summing the same e; every other
    step as ``exp_attention_ref``."""
    Bq, n, C3 = qkv.shape
    d = C3 // 3 // heads
    vk = valid.float()[:, :, None, None]
    q, k, v = qkv.reshape(Bq, n, 3, heads, d).unbind(2)
    e = torch.exp(ein("bnhd,bmhd->bhnm", q, k * vk) * scale)
    o = ein("bhnm,bmhd->bnhd", e, v * vk)
    r = 1.0 / (torch.einsum("bhnm,bm->bnh", e, valid.float()) + 1e-30)
    return (o * r[..., None]).reshape(Bq, n, C3 // 3)


@pytest.mark.parametrize("heads", [2, 4])
def test_3xtf32_forward_stays_at_f32_accuracy(heads):
    """The f32 forward's design on the card (``csrc/attn_exp.cuh``): its two
    products in 3xTF32 stay within 1e-6 rel L2 of the f32 plain version;
    one TF32 pass would not (~1e-3). The sequence with no valid key gives
    o = 0."""
    qkv, mask = _inputs(97, seed=7)
    x = torch.tensor(qkv)
    valid = torch.tensor(mask > -1.0).float()
    scale = (C // heads) ** -0.5
    want, _ = tmha.mha_fwd_ref(x, valid, heads, scale)
    three = _fwd_emulated(x, valid, heads, scale, _einsum_tf32(3))
    one = _fwd_emulated(x, valid, heads, scale, _einsum_tf32(1))
    r3, r1 = (_rel(a.numpy(), want.numpy()) for a in (three, one))
    print(f"forward rel L2 to f32, {heads} heads: 3xTF32 {r3}, one pass {r1}")
    assert r3 <= 1e-6
    assert r1 >= 1e-4
    assert not three[3].any()
