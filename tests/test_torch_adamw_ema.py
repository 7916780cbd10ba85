"""Plain version of the fused AdamW + EMA update K7 against the JAX package:
the Pallas kernel ``ops/pallas_opt.py:fused_adamw_ema_pallas`` in
interpret mode, and the XLA path ``training/pretrain.py:fused_adamw_ema``.

Leaves with and without a teacher copy, with weight decay (>= 2-D) and
without (1-D), large enough for the Pallas streaming path and small ones
for its inline path; Adam counts 1 and 5. Tolerance rel 1e-6 of each
state tensor's largest value (the same f32 operations; where a moment
cancels to ~0 an element's own relative error is meaningless).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import pallas_opt as jpo  # noqa: E402
from audiossl_tpu.training import pretrain as jpt  # noqa: E402
from audiossl_tpu_torch.kernels import build as kb  # noqa: E402
from audiossl_tpu_torch.ops import adamw_ema as tae  # noqa: E402

SHAPES = {"big": (256, 512), "square": (300, 300), "bias": (512,),
          "small": (64, 64)}
TEACHER = ("big", "bias")  # leaves the teacher holds
LR, WD, M = 8e-5, 0.04, 0.9996


def _state(count):
    rng = np.random.RandomState(count)

    def n(shape, s):
        return (rng.randn(*shape) * s).astype(np.float32)

    p = {k: n(s, 0.02) for k, s in SHAPES.items()}
    g = {k: n(s, 1e-3) for k, s in SHAPES.items()}
    mu = {k: n(s, 1e-4) for k, s in SHAPES.items()}
    nu = {k: np.abs(n(s, 1e-6)) for k, s in SHAPES.items()}
    t = {k: p[k] + n(SHAPES[k], 1e-3) for k in TEACHER}
    return p, g, mu, nu, t


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_adamw_ema_ref_matches_jax(count, reference):
    p, g, mu, nu, t = _state(count)
    cfg = jpt.OptimizerConfig()
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    opt = optax.ScaleByAdamState(count=jnp.asarray(count - 1, jnp.int32),
                                 mu=j(mu), nu=j(nu))
    mask = {k: len(s) >= 2 for k, s in SHAPES.items()}
    args = (j(p), j(g), opt, j(t), jnp.float32(LR), jnp.float32(WD),
            jnp.float32(M), mask, cfg)
    if reference == "pallas":
        assert jpo._eligible(args[0]["big"]) and jpo._eligible(
            args[0]["square"])
        wp, wopt, wt = jpo.fused_adamw_ema_pallas(*args, interpret=True)
    else:
        wp, wopt, wt = jpt.fused_adamw_ema(*args)
    assert int(wopt.count) == count

    names = list(SHAPES)
    tt = lambda d: [torch.tensor(d[k]) for k in names]  # noqa: E731
    gp, gg, gmu, gnu = tt(p), tt(g), tt(mu), tt(nu)
    gt = [torch.tensor(t[k]) if k in t else None for k in names]
    kb.reset_launches()
    tae.adamw_ema(gp, gg, gmu, gnu, gt, [mask[k] for k in names],
                  tae.update_scalars(LR, WD, M, count, cfg.b1, cfg.b2,
                                     cfg.eps))
    assert kb.LAUNCHES["adamw_ema"] == 0  # CPU tensors: the plain version
    for i, k in enumerate(names):
        pairs = [(gp[i], wp[k]), (gmu[i], wopt.mu[k]), (gnu[i], wopt.nu[k])]
        if k in t:
            pairs.append((gt[i], wt[k]))
        for got, want in pairs:
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=k)
    assert set(wt) == set(TEACHER)
