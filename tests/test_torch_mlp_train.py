"""Plain version of the trainable MLP half K5 against the JAX Pallas kernel
``audiossl_tpu/ops/pallas_mlp.py:fused_mlp_block`` run in interpret mode on
the CPU.

B=4 sequences of N=24 tokens, width 16, hidden 64, drop-path multipliers
[1, 0, 1.25, 1]. The value, the saved pre-activation u and all seven
gradients of sum(y * w) are compared, with the f32 tolerances of
``tests/test_pallas_kernels.py:429-443`` (value atol 3e-5, gradients atol
3e-4 * max(1, max |ref|)); the bf16 case checks the rounding points.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import pallas_mlp as jpm  # noqa: E402
from audiossl_tpu_torch.ops import mlp_train as tmt  # noqa: E402

B, N, C, HD = 4, 24, 16, 64
EPS = 1e-6
DP = np.asarray([1.0, 0.0, 1.25, 1.0], np.float32)
NAMES = ["dx", "dls", "dlb", "dw1", "db1", "dw2", "db2"]


def _inputs(seed):
    rng = np.random.RandomState(seed)

    def n(*shape, s=1.0, off=0.0):
        return (rng.randn(*shape) * s + off).astype(np.float32)

    return dict(x=n(B, N, C), dp=DP, ls=n(C, s=0.1, off=1.0), lb=n(C, s=0.1),
                w1=n(C, HD, s=0.3), b1=n(HD, s=0.1), w2=n(HD, C, s=0.2),
                b2=n(C, s=0.1), w=n(B, N, C))


def _jax(p, dtype):
    x = jnp.asarray(p["x"], dtype)
    dp = jnp.asarray(p["dp"])
    params = [jnp.asarray(p[k]) for k in ("ls", "lb", "w1", "b1", "w2", "b2")]
    y, res = jpm._fwd(x, dp, *params, EPS, True)

    def loss(x, ls, lb, w1, b1, w2, b2):
        out = jpm.fused_mlp_block(x, dp, ls, lb, w1, b1, w2, b2, EPS, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(p["w"]))

    grads = jax.grad(loss, argnums=tuple(range(7)))(x, *params)
    grads = [np.asarray(g, np.float32) for g in grads]
    grads[3] = grads[3].T  # [C, Hd] -> torch's [Hd, C]
    grads[5] = grads[5].T
    return np.asarray(y, np.float32), np.asarray(res[-1], np.float32), grads


def _port(p, dtype):
    t = lambda a: torch.tensor(a)  # noqa: E731
    x = t(p["x"]).to(dtype).requires_grad_()
    params = [t(p["ls"]), t(p["lb"]), t(p["w1"].T.copy()), t(p["b1"]),
              t(p["w2"].T.copy()), t(p["b2"])]
    for q in params:
        q.requires_grad_()
    y, u = tmt.mlp_train_fwd(x.detach(), t(p["dp"]), *params, EPS)
    out = tmt.fused_mlp_block(x, t(p["dp"]), *params, EPS)
    (out.float() * t(p["w"])).sum().backward()
    f = lambda a: a.detach().float().numpy()  # noqa: E731
    return f(y), f(u), [f(x.grad)] + [f(q.grad) for q in params], f(out)


def test_mlp_train_ref_matches_pallas_f32():
    p = _inputs(0)
    jy, ju, jg = _jax(p, jnp.float32)
    y, u, g, out = _port(p, torch.float32)
    np.testing.assert_allclose(y, jy, atol=3e-5)
    np.testing.assert_array_equal(out, y)
    np.testing.assert_allclose(u, ju, atol=3e-5)
    for name, a, b in zip(NAMES, g, jg):
        sc = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=3e-4 * sc, err_msg=name)


def test_mlp_train_ref_bf16_rounding_points():
    """bf16 activations: u, gelu(u), dy * dp and du are rounded where the
    Pallas kernel rounds them (db1 and db2 sum the f32 values, as there).
    An element may land one bf16 step apart where the f32 sums run in
    another order; dropping a rounding point moves the relative L2 error
    to ~1e-3."""
    p = _inputs(1)
    jy, ju, jg = _jax(p, jnp.bfloat16)
    y, u, g, _ = _port(p, torch.bfloat16)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for a, b in ((y, jy), (u, ju), (g[0], jg[0])):
        assert rel(a, b) < 3e-4 and np.mean(a == b) > 0.97
    for name, a, b in zip(NAMES[1:], g[1:], jg[1:]):
        assert rel(a, b) < 1e-4, (name, rel(a, b))
