"""The module route's GELU (``ops/gelu.py``, ``csrc/gelu.cu``).

On the CPU: ``gelu_exact`` stays the eager chain bit for bit, forward and
gradient; the kernels' plain versions match the JAX package's
``gelu_exact`` and its ``jax.grad`` (f32 within 1e-6 relative, bf16
within one unit in the last place), at a length that is a whole number of
16-byte vectors and one that leaves a tail; the wrapper takes the plain
versions only for a CPU tensor, and autograd keeps u alone.

On the card (``card``, skipped without one; run there with ``python -m
pytest --noconftest tests/test_torch_gelu.py -m card``): both kernels
against their plain versions at the finetuning step's fc1 pre-activation
[19,328, 3,072] and at an odd length, in f32 and bf16, one launch a call;
a tensor past the launch's element limit in pieces.
"""
import numpy as np
import pytest
import torch

from audiossl_tpu_torch.kernels import build as kb
from audiossl_tpu_torch.models import transformer as ttr
from audiossl_tpu_torch.ops import gelu as tg

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _eager_gelu(x):
    """``gelu_exact``'s eager chain, frozen here: its CPU path must stay
    this, bit for bit."""
    xf = x.float()
    return (0.5 * xf * (1.0 + ttr.erf_approx(xf * 0.7071067811865476))
            ).to(x.dtype)


def _u(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * 3.0).to(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_exact_on_the_cpu_is_the_eager_chain(dtype):
    x = _u((37, 65), 0, DTYPES[dtype])
    dy = _u((37, 65), 1, DTYPES[dtype])
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya, yb = ttr.gelu_exact(a), _eager_gelu(b)
    ya.backward(dy)
    yb.backward(dy)
    assert ya.dtype == x.dtype and torch.equal(ya, yb)
    assert torch.equal(a.grad, b.grad)


def _jax_gelu(u_np, dy_np, dtype):
    """The JAX package's ``gelu_exact`` and its gradient (a VJP with dy)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from audiossl_tpu.models import transformer as jtr

    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    u = jnp.asarray(u_np).astype(jdt)
    y, vjp = jax.vjp(jtr.gelu_exact, u)
    du, = vjp(jnp.asarray(dy_np).astype(jdt))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(du.astype(jnp.float32)))


def _within(got, want, dtype):
    """f32: within 1e-6 of each value; bf16: within one unit in the last
    place (2^-7 of the value at most); both above a floor of 1e-6 of the
    largest value, where cancellation leaves a value near 0."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = 1e-6 * np.abs(want).max()
    rel = 1e-6 if dtype == "f32" else 2.0 ** -7
    bad = np.abs(got - want) > rel * np.abs(want) + floor
    assert not bad.any(), (f"{bad.sum()} of {bad.size} beyond; worst "
                           f"{np.abs(got - want).max()}")


@pytest.mark.parametrize("n", [4096, 4099])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_versions_match_the_jax_package(dtype, n):
    u = _u((n,), 2, DTYPES[dtype])
    dy = _u((n,), 3, DTYPES[dtype])
    y_j, du_j = _jax_gelu(u.float().numpy(), dy.float().numpy(), dtype)
    y = tg.gelu_fwd_ref(u)
    du = tg.gelu_bwd_ref(u, dy)
    assert y.dtype == du.dtype == u.dtype
    _within(y.float().numpy(), y_j, dtype)
    _within(du.float().numpy(), du_j, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wrapper_takes_the_plain_versions_only_on_the_cpu(dtype):
    u = _u((3, 7, 33), 4, DTYPES[dtype]).requires_grad_(True)
    dy = _u((3, 7, 33), 5, DTYPES[dtype])
    kb.reset_launches()
    y = tg.gelu(u)
    y.backward(dy)
    assert torch.equal(y, tg.gelu_fwd_ref(u.detach()))
    assert torch.equal(u.grad, tg.gelu_bwd_ref(u.detach(), dy))
    assert kb.LAUNCHES["gelu_fwd"] == kb.LAUNCHES["gelu_bwd"] == 0
    meta = torch.empty(3, 7, 33, device="meta", dtype=DTYPES[dtype])
    for call in (lambda: tg.gelu(meta), lambda: ttr.gelu_exact(meta),
                 lambda: tg.gelu_bwd(meta, meta)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert kb.LAUNCHES["gelu_fwd"] == kb.LAUNCHES["gelu_bwd"] == 0


def test_autograd_keeps_u_alone():
    """The wrapper saves u for its backward; the eager chain saves more
    tensors of u's size (the 0.5 u, 1 + erf and u / sqrt 2 operands)."""
    def saved(fn):
        kept = []
        u = _u((8, 16), 6).requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: kept.append(t) or t, lambda t: t):
            fn(u)
        return sum(t.numel() for t in kept) // u.numel()

    assert saved(tg.gelu) == 1
    assert saved(_eager_gelu) >= 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("shape", [(19328, 3072), (1001, 7)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernels_match_their_plain_versions_on_the_card(dtype, shape):
    _card()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    u = (torch.randn(*shape, generator=g, device=dev) * 3.0).to(DTYPES[dtype])
    dy = torch.randn(*shape, generator=g, device=dev).to(DTYPES[dtype])
    kb.reset_launches()
    y = tg.gelu_fwd(u)
    assert kb.LAUNCHES["gelu_fwd"] == 1
    du = tg.gelu_bwd(u, dy)
    assert kb.LAUNCHES["gelu_bwd"] == 1
    torch.cuda.synchronize()
    assert y.dtype == du.dtype == u.dtype
    _within(y.float().cpu().numpy(), tg.gelu_fwd_ref(u).float().cpu().numpy(),
            dtype)
    _within(du.float().cpu().numpy(),
            tg.gelu_bwd_ref(u, dy).float().cpu().numpy(), dtype)
    # through autograd: one launch each way
    kb.reset_launches()
    ur = u.clone().requires_grad_(True)
    ttr.gelu_exact(ur).backward(dy)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["gelu_fwd"] == kb.LAUNCHES["gelu_bwd"] == 1
    assert torch.equal(ur.grad, du)


@pytest.mark.card
def test_kernels_split_a_tensor_past_the_chunk_on_the_card(monkeypatch):
    """A tensor of more than ``CHUNK`` elements (2^30, under the limit of
    the launch's C int count) goes in pieces, one launch each, with the result of one launch;
    shown here with a chunk of 2^20 and a tail."""
    _card()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    n = 3 * (1 << 20) + 13
    u = torch.randn(n, generator=g, device=dev) * 3.0
    dy = torch.randn(n, generator=g, device=dev)
    whole = (tg.gelu_fwd(u), tg.gelu_bwd(u, dy))
    monkeypatch.setattr(tg, "CHUNK", 1 << 20)
    kb.reset_launches()
    parts = (tg.gelu_fwd(u), tg.gelu_bwd(u, dy))
    torch.cuda.synchronize()
    assert kb.LAUNCHES["gelu_fwd"] == kb.LAUNCHES["gelu_bwd"] == 4
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))
