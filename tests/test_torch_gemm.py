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
