"""Plain version of the trainable attention half K4 against the JAX Pallas
kernel ``audiossl_tpu/ops/pallas_attn.py:fused_attn_block`` run in interpret
mode on the CPU.

B=4 sequences of N=24 tokens, 2 heads of width 8; valid lengths
[16, 24, 9, 0] (the last sequence has no valid key), drop-path multipliers
[1, 0, 1.25, 1]. The value, the saved residuals qkv/o/r and all seven
gradients of sum(y * w) are compared. f32 tolerances as
``tests/test_pallas_kernels.py:429-443``: value atol 3e-5, gradients
atol 3e-4 * max(1, max |ref|). The bf16 case checks that the plain version
rounds where the Pallas kernel rounds.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import pallas_attn as jpa  # noqa: E402
from audiossl_tpu_torch.ops import attn_train as tat  # noqa: E402

B, N, H, D = 4, 24, 2, 8
C = H * D
EPS = 1e-6
LENGTHS = np.asarray([16, 24, 9, 0])
DP = np.asarray([1.0, 0.0, 1.25, 1.0], np.float32)
NAMES = ["dx", "dls", "dlb", "dwqkv", "dbqkv", "dwproj", "dbproj"]


def _inputs(seed):
    rng = np.random.RandomState(seed)

    def n(*shape, s=1.0, off=0.0):
        return (rng.randn(*shape) * s + off).astype(np.float32)

    valid = (np.arange(N)[None, :] < LENGTHS[:, None]).astype(np.float32)
    return dict(x=n(B, N, C), valid=valid, dp=DP, ls=n(C, s=0.1, off=1.0),
                lb=n(C, s=0.1), wqkv=n(C, 3 * C, s=0.1), bqkv=n(3 * C, s=0.1),
                wproj=n(C, C, s=0.1), bproj=n(C, s=0.1), w=n(B, N, C))


def _jax(p, dtype):
    args = (jnp.asarray(p["x"], dtype), jnp.asarray(p["valid"]),
            jnp.asarray(p["dp"]), jnp.asarray(p["ls"]), jnp.asarray(p["lb"]),
            jnp.asarray(p["wqkv"]), jnp.asarray(p["bqkv"]),
            jnp.asarray(p["wproj"]), jnp.asarray(p["bproj"]))
    y, res = jpa._fwd(*args, H, EPS, True)
    qkv, r, o = res[7], res[8], res[9]

    def loss(x, ls, lb, wqkv, bqkv, wproj, bproj):
        out = jpa.fused_attn_block(x, args[1], args[2], ls, lb, wqkv, bqkv,
                                   wproj, bproj, H, EPS, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(p["w"]))

    grads = jax.grad(loss, argnums=tuple(range(7)))(
        args[0], *args[3:])
    grads = [np.asarray(g, np.float32) for g in grads]
    grads[3] = grads[3].T  # [C, 3C] -> torch's [3C, C]
    grads[5] = grads[5].T
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(y), f(qkv), f(o), f(r), grads


def _port(p, dtype):
    t = lambda a: torch.tensor(a)  # noqa: E731
    x = t(p["x"]).to(dtype).requires_grad_()
    params = [t(p["ls"]), t(p["lb"]), t(p["wqkv"].T.copy()), t(p["bqkv"]),
              t(p["wproj"].T.copy()), t(p["bproj"])]
    for q in params:
        q.requires_grad_()
    ls, lb, wq, bq, wp, bp = params
    y, qkv, o, r = tat.attn_train_fwd(x.detach(), t(p["valid"]), t(p["dp"]),
                                      ls, lb, wq, bq, wp, bp, H, EPS)
    out = tat.fused_attn_block(x, t(p["valid"]), t(p["dp"]), ls, lb, wq, bq,
                               wp, bp, H, EPS)
    (out.float() * t(p["w"])).sum().backward()
    f = lambda a: a.detach().float().numpy()  # noqa: E731
    grads = [f(x.grad)] + [f(q.grad) for q in params]
    return f(y), f(qkv), f(o), f(r), grads, f(out)


def test_attn_train_ref_matches_pallas_f32():
    p = _inputs(0)
    jy, jqkv, jo, jr, jg = _jax(p, jnp.float32)
    y, qkv, o, r, g, out = _port(p, torch.float32)
    np.testing.assert_allclose(y, jy, atol=3e-5)
    np.testing.assert_array_equal(out, y)
    np.testing.assert_allclose(qkv, jqkv, atol=3e-5)
    np.testing.assert_allclose(o, jo, atol=3e-5)
    np.testing.assert_allclose(r, jr, rtol=3e-5)
    for name, a, b in zip(NAMES, g, jg):
        sc = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=3e-4 * sc, err_msg=name)


def test_attn_train_ref_bf16_rounding_points():
    """bf16 activations: qkv, o, exp(s), delta's products, do*r, t and
    dqkv are rounded where the Pallas kernel rounds them. The sums run in
    another order on each side, so an element may land one bf16 step
    (2^-8 relative) apart; dropping a rounding point moves many elements
    and the relative L2 error to ~1e-3, which these bounds reject."""
    p = _inputs(1)
    jy, jqkv, jo, jr, jg = _jax(p, jnp.bfloat16)
    y, qkv, o, r, g, _ = _port(p, torch.bfloat16)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for a, b in ((y, jy), (qkv, jqkv), (o, jo), (r, jr), (g[0], jg[0])):
        assert rel(a, b) < 3e-4 and np.mean(a == b) > 0.97
    # the parameter gradients are f32 sums of the same bf16 operands
    for name, a, b in zip(NAMES[1:], g[1:], jg[1:]):
        assert rel(a, b) < 1e-4, (name, rel(a, b))
