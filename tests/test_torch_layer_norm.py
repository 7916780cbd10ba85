"""The port's ``layer_norm`` (LayerNormPG's norm) against the JAX
``audiossl_tpu/ops/pallas_ln.py:layer_norm`` on the CPU: the fast-variance
forward, and the backward (K8's plain version) against ``jax.grad`` through
the Pallas kernel in interpret mode.

Rows R = 37, 150 and 1000 (none a multiple of the kernel's row block), C
in {96, 100, 384} (100 bf16 values are not a whole number of 16-byte
vectors); gradients of sum(sin(y)). f32: rel L2 <= 1e-5; bf16 (x and
the incoming gradient rounded to bf16 where the Pallas path rounds them):
dx rel L2 <= 1e-2, dscale/dbias (f32 sums of the same bf16 operands) 1e-4.
Constant rows (variance 0) stay finite.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import pallas_ln as jln  # noqa: E402
from audiossl_tpu_torch.models.transformer import LayerNormPG  # noqa: E402
from audiossl_tpu_torch.ops import layer_norm as tln  # noqa: E402

EPS = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    C = shape[-1]
    return (rng.randn(*shape).astype(np.float32) * 2.0 + 0.3,
            (rng.rand(C) + 0.5).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32))


def _jax(x, s, b, dtype):
    def loss(x, s, b):
        y = jln.layer_norm(x, s, b, EPS, dtype, True)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    args = (jnp.asarray(x, dtype), jnp.asarray(s), jnp.asarray(b))
    y = jln.layer_norm(*args, EPS, dtype, True)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(a, np.float32) for a in (y, *grads)]


def _port(x, s, b, dtype):
    xt = torch.tensor(x).to(dtype).requires_grad_()
    st = torch.tensor(s).requires_grad_()
    bt = torch.tensor(b).requires_grad_()
    y = tln.layer_norm(xt, st, bt, EPS, dtype)
    torch.sin(y.float()).sum().backward()
    return [a.detach().float().numpy() for a in (y, xt.grad, st.grad, bt.grad)]


@pytest.mark.parametrize("shape", [(3, 50, 96), (1000, 384), (37, 100)])
def test_layer_norm_matches_pallas_f32(shape):
    x, s, b = _inputs(shape, seed=shape[-1])
    want = _jax(x, s, b, jnp.float32)
    got = _port(x, s, b, torch.float32)
    for name, a, w in zip(("y", "dx", "dscale", "dbias"), got, want):
        assert a.shape == w.shape, name
        assert _rel(a, w) <= 1e-5, (name, _rel(a, w))


@pytest.mark.parametrize("shape", [(3, 50, 96), (37, 100)])
def test_layer_norm_matches_pallas_bf16(shape):
    x, s, b = _inputs(shape, seed=1)
    want = _jax(x, s, b, jnp.bfloat16)
    got = _port(x, s, b, torch.bfloat16)
    for name, a, w, tol in zip(("y", "dx", "dscale", "dbias"), got, want,
                               (1e-2, 1e-2, 1e-4, 1e-4)):
        assert _rel(a, w) <= tol, (name, _rel(a, w))


def test_constant_rows_stay_finite():
    """A constant row has variance 0; the fast variance of its f32 values
    may round below 0 and is clamped there, as in JAX: the output is the
    bias (up to x - mu's rounding times rsqrt(eps) = 1000) and every
    gradient finite."""
    x = np.full((5, 96), 0.1, np.float32) * np.arange(1, 6, dtype=np.float32
                                                      )[:, None]
    _, s, b = _inputs((5, 96), seed=2)
    want = _jax(x, s, b, jnp.float32)
    got = _port(x, s, b, torch.float32)
    for a in got:
        assert np.all(np.isfinite(a))
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[0], np.broadcast_to(b, (5, 96)), atol=1e-3)


def test_layer_norm_pg_module_is_a_layer_norm():
    """``LayerNormPG`` keeps ``nn.LayerNorm``'s parameters and names (a
    state dict interchanges) and outputs in its input's dtype."""
    ln = LayerNormPG(32)
    ref = torch.nn.LayerNorm(32, eps=1e-6)
    assert set(ln.state_dict()) == set(ref.state_dict()) == {"weight", "bias"}
    ln.load_state_dict(ref.state_dict())
    x = torch.randn(2, 7, 32, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(ln(x).detach().numpy(),
                               ref(x).detach().numpy(), atol=1e-5)
    assert ln(x.bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("shape,dtype", [
    ((192 * 151, 384), torch.float32), ((192 * 250, 768), torch.bfloat16),
    ((37, 100), torch.bfloat16), ((2, 5, 1000), torch.float32)])
def test_kernel_path_launch_gets_the_partial_buffer(shape, dtype,
                                                    monkeypatch):
    """K8's launcher gets x and dy as [R, C], dx of x's shape and type, one
    f32 row of column sums [2, C] per block of its grid (two blocks an SM
    at most, none without a row), and a [2, C] f32 output whose rows are
    the dscale and dbias returned; no zeroed buffer. Meta tensors reach the
    kernel path; the launch is captured instead of run."""
    from audiossl_tpu_torch.kernels import build as kb

    launched = []
    monkeypatch.setattr(kb, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kb, "ptr", lambda t: t)
    monkeypatch.setattr(kb, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    monkeypatch.setattr(tln, "_sm_count", lambda dev: 132)
    meta = torch.device("meta")
    x = torch.empty(shape, device=meta, dtype=dtype)
    C, R = shape[-1], int(np.prod(shape[:-1]))
    dx, ds, db = tln.ln_bwd(x, torch.empty_like(x),
                            torch.empty(C, device=meta), 1e-6)
    (name, args), = launched
    xa, ga, sa, dxa, partial, dsb, blocks, code, r, c, eps = args
    assert name == "ln_pg_bwd" and (r, c, eps) == (R, C, 1e-6)
    assert code == kb.DTYPE_CODES[dtype]
    assert tuple(xa.shape) == tuple(ga.shape) == tuple(dxa.shape) == (R, C)
    assert dxa.dtype == dtype and dx.shape == x.shape
    assert blocks == min(2 * 132, -(-R // 8))
    assert tuple(partial.shape) == (blocks, 2, C)
    assert partial.dtype == dsb.dtype == torch.float32
    assert tuple(dsb.shape) == (2, C)
    assert ds.shape == db.shape == (C,)
    assert ds._base is dsb and db._base is dsb
    assert (ds.storage_offset(), db.storage_offset()) == (0, C)
