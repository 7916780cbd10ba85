"""The block kernels' bf16 GEMM template alone (``ops/gemm.py``, the hook
over ``csrc/gemm.cu``) on the CPU, where the wrapper takes its plain
version: each operand layout against numpy float64 products of the same
bf16 operands, with M, N and K that are no multiple of the template's
128 x 128 x 64 tile; the K splits of the atomic epilogue; and the checks
that refuse, before any launch, what the template's TMA loads cannot take.

f32 outputs: rel L2 <= 1e-5 (exact bf16 products, f32 sums in another
order); the bias epilogue's bf16 output: rel L2 <= 4e-3 (one rounding of
sum + bias to bf16) -- the tolerances ``chip_smoke.py`` holds the
template to on the card.

The int8 template alone (``gemm_s8``): its plain version bit-equal to the
JAX package's ``_q8_dot`` on the same codes and scales at K = 768 and
3,072 (the int32 sum is exact, so the card is held to 0 mismatches), its
bias epilogue rounding once, and the arguments it refuses.
"""
import numpy as np
import pytest
import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.ops import gemm

F32_REL, BIAS_REL = 1e-5, 4e-3
# (M, N, K) per layout: ragged against the tile, every contiguous extent a
# multiple of 8 (forward: K; dx: K and N; weight_grad: M and N)
SHAPES = {"forward": (97, 131, 200), "dx": (97, 136, 200),
          "weight_grad": (136, 200, 197)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _operands(layout, seed=0):
    """bf16 operands of ``layout`` as the template reads them, and the
    float64 [M, K] and [K, N] matrices of their product."""
    M, N, K = SHAPES[layout]
    rng = np.random.RandomState(seed)
    shapes = {"forward": ((M, K), (N, K)), "dx": ((M, K), (K, N)),
              "weight_grad": ((K, M), (K, N))}[layout]
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16()
            for s in shapes)
    lhs, rhs = a.double().numpy(), b.double().numpy()
    if layout == "forward":
        rhs = rhs.T
    elif layout == "weight_grad":
        lhs = lhs.T
    return a, b, lhs, rhs


@pytest.mark.parametrize("layout", list(gemm.LAYOUTS))
def test_plain_product_matches_float64(layout):
    a, b, lhs, rhs = _operands(layout)
    got = gemm.gemm_bf16(a, b, layout)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (lhs.shape[0], rhs.shape[1])
    assert _rel(got, lhs @ rhs) <= F32_REL


@pytest.mark.parametrize("layout", list(gemm.LAYOUTS))
def test_bias_epilogue_rounds_once_to_bf16(layout):
    a, b, lhs, rhs = _operands(layout, seed=1)
    bias = torch.from_numpy(
        np.random.RandomState(2).randn(rhs.shape[1]).astype(np.float32))
    got = gemm.gemm_bf16(a, b, layout, "bias", bias=bias)
    want = lhs @ rhs + bias.double().numpy()
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= BIAS_REL
    # exactly one rounding: the plain version's f32 sum + bias, to bf16
    f32 = gemm.gemm_bf16(a, b, layout) + bias
    assert torch.equal(got, f32.bfloat16())


@pytest.mark.parametrize("layout", list(gemm.LAYOUTS))
@pytest.mark.parametrize("splits", [2, 3])
def test_atomic_splits_sum_to_the_unsplit_product(layout, splits):
    a, b, lhs, rhs = _operands(layout, seed=3)
    whole = gemm.gemm_bf16(a, b, layout)
    got = gemm.gemm_bf16(a, b, layout, "atomic", splits=splits)
    assert torch.allclose(got, whole, rtol=1e-5, atol=1e-4)
    assert _rel(got, lhs @ rhs) <= F32_REL
    if layout == "weight_grad":  # the block kernels' own split count
        own = gemm.gemm_bf16(a, b, layout, "atomic", splits=0)
        assert _rel(own, lhs @ rhs) <= F32_REL


def _no_launch(monkeypatch):
    def fail(*args, **kwargs):
        raise AssertionError("the template was launched")
    monkeypatch.setattr(kb, "call", fail)


@pytest.mark.parametrize("layout", list(gemm.LAYOUTS))
def test_contiguous_extent_not_a_multiple_of_8_raises(layout, monkeypatch):
    _no_launch(monkeypatch)
    a, b, _, _ = _operands(layout)
    # drop a column from the operand whose rows are contiguous in K (A of
    # forward and dx) or in M (A of weight_grad)
    bad = a[:, :-1].contiguous()
    with pytest.raises(ValueError, match="multiple of 8"):
        gemm.gemm_bf16(bad, b, layout)
    bad_b = b[:, :-3].contiguous()
    with pytest.raises(ValueError, match="multiple of 8"):
        gemm.gemm_bf16(a, bad_b, layout)


def test_misaligned_or_strided_operand_raises(monkeypatch):
    _no_launch(monkeypatch)
    a, b, _, _ = _operands("forward")
    M, K = a.shape
    # the same values 2 bytes past a 16-byte boundary: contiguous, but no
    # TMA base
    flat = torch.empty(M * K + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + M * K].view(M, K)
    shifted.copy_(a)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        gemm.gemm_bf16(shifted, b, "forward")
    with pytest.raises(ValueError, match="16-byte aligned"):
        gemm.gemm_bf16(a, b.t(), "dx")  # a transposed view is not stored


@pytest.mark.parametrize("bad", ["dtype", "shapes", "bias", "splits"])
def test_refused_arguments_raise(bad, monkeypatch):
    _no_launch(monkeypatch)
    a, b, _, _ = _operands("forward")
    with pytest.raises(ValueError):
        if bad == "dtype":
            gemm.gemm_bf16(a.float(), b, "forward")
        elif bad == "shapes":
            gemm.gemm_bf16(a, b[:, :192].contiguous(), "forward")
        elif bad == "bias":
            gemm.gemm_bf16(a, b, "forward", "bias",
                           bias=torch.zeros(b.shape[0] + 1))
        else:
            gemm.gemm_bf16(a, b, "forward", "f32", splits=2)


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    """A meta tensor passes the shape checks and reaches the kernel path,
    which refuses a device that is not CUDA before it launches."""
    _no_launch(monkeypatch)
    meta = torch.device("meta")
    a = torch.empty(97, 200, dtype=torch.bfloat16, device=meta)
    b = torch.empty(131, 200, dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        gemm.gemm_bf16(a, b, "forward")


# The int8 template (``gemm_s8``): codes a [M, K] and b [N, K], M and N
# ragged against the 128 x 128 tile
S8_M, S8_N = 200, 136


def _s8_operands(K, seed=0):
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randint(-127, 128, (S8_M, K)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (S8_N, K)).astype(np.int8))
    ra = torch.from_numpy(rng.rand(S8_M).astype(np.float32) * 1e-2)
    sb = torch.from_numpy(rng.rand(S8_N).astype(np.float32) * 1e-3)
    return a, b, ra, sb


@pytest.mark.parametrize("K", [768, 3072])
def test_s8_plain_product_is_jax_q8_dot_bit_for_bit(K):
    """On the codes and scales of JAX's ``_q8_act`` and
    ``quantize_weight_q8``, the plain version equals ``_q8_dot`` bit for
    bit: the exact product rounded once to f32, then the row scale, then
    the column scale -- what the template computes on the card."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from audiossl_tpu.ops import pallas_block as jpb
    from audiossl_tpu_torch.ops import quant

    rng = np.random.RandomState(K)
    h = (rng.randn(S8_M, K) * 2.0).astype(np.float32)
    wj = (rng.randn(K, S8_N) * 0.05).astype(np.float32)  # JAX [in, out]
    jq, js = jpb.quantize_weight_q8(jnp.asarray(wj))
    want = np.asarray(jpb._q8_dot(jnp.asarray(h), jq, js))
    q, r = quant.q8_act(torch.from_numpy(h))
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jpb._q8_act(jnp.asarray(h))[0]))
    b = torch.from_numpy(np.ascontiguousarray(np.asarray(jq).T))  # [N, K]
    s = torch.from_numpy(np.asarray(js)[0].copy())
    got = gemm.gemm_s8(q, b, r[:, 0].contiguous(), s)
    assert got.dtype == torch.float32 and tuple(got.shape) == (S8_M, S8_N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [768, 3072])
def test_s8_bias_epilogue_rounds_once_to_bf16(K):
    a, b, ra, sb = _s8_operands(K, seed=1)
    bias = torch.from_numpy(
        np.random.RandomState(2).randn(S8_N).astype(np.float32))
    got = gemm.gemm_s8(a, b, ra, sb, "bias", bias=bias)
    f32 = gemm.gemm_s8(a, b, ra, sb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (f32 + bias).bfloat16())
    want = (a.double() @ b.double().t()) * ra.double()[:, None] \
        * sb.double() + bias.double()
    assert _rel(got.float(), want) <= BIAS_REL


@pytest.mark.parametrize("bad", ["dtype", "shapes", "k16", "misaligned",
                                 "strided", "scales", "bias", "epilogue"])
def test_s8_refused_arguments_raise(bad, monkeypatch):
    _no_launch(monkeypatch)
    a, b, ra, sb = _s8_operands(256)
    with pytest.raises(ValueError):
        if bad == "dtype":
            gemm.gemm_s8(a.float(), b, ra, sb)
        elif bad == "shapes":
            gemm.gemm_s8(a, b[:, :240].contiguous(), ra, sb)
        elif bad == "k16":  # the TMA row pitch: K a multiple of 16 bytes
            gemm.gemm_s8(a[:, :248].contiguous(), b[:, :248].contiguous(),
                         ra, sb)
        elif bad == "misaligned":
            flat = torch.empty(a.numel() + 16, dtype=torch.int8)
            shifted = flat[1:1 + a.numel()].view(a.shape)
            shifted.copy_(a)
            assert shifted.is_contiguous() and shifted.data_ptr() % 16
            gemm.gemm_s8(shifted, b, ra, sb)
        elif bad == "strided":  # [K, N] read as b^T is not K-major
            gemm.gemm_s8(a, b.t().contiguous().t(), ra, sb)
        elif bad == "scales":
            gemm.gemm_s8(a, b, ra[:-1].contiguous(), sb)
        elif bad == "bias":
            gemm.gemm_s8(a, b, ra, sb, "bias", bias=torch.zeros(S8_N + 1))
        else:
            gemm.gemm_s8(a, b, ra, sb, "atomic")


def test_s8_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    """Meta codes pass the checks and reach the kernel path, which refuses
    a device that is not CUDA before it launches."""
    _no_launch(monkeypatch)
    meta = torch.device("meta")
    a = torch.empty(97, 256, dtype=torch.int8, device=meta)
    b = torch.empty(131, 256, dtype=torch.int8, device=meta)
    ra = torch.empty(97, device=meta)
    sb = torch.empty(131, device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        gemm.gemm_s8(a, b, ra, sb)
