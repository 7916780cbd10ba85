"""Plain versions of the int8 trainable halves K4q/K5q against the JAX
Pallas kernels (``pallas_attn.py:fused_attn_block`` and
``pallas_mlp.py:fused_mlp_block`` with ``quant``) run in interpret mode on
the CPU, and the route of the int8 options through a pretraining step.

The halves: B=4 sequences of N=24 tokens, valid lengths [16, 24, 9, 0]
(the last sequence has no valid key), drop-path multipliers
[1, 0, 1.25, 1]; attention 2 heads of width 8, MLP width 16 with hidden
64. The value and all seven gradients of sum(y * w) under ``"int8"`` and
``"int8dx"``, in f32 and in bf16: rel L2 <= 5e-3 (both sides quantize the
same values and take exact int8 products; a sum in another order can flip
a rare code). The port's own int8-vs-float budget mirrors
``tests/test_pallas_kernels.py:479-564`` with its inputs: forward <= 2e-2,
every gradient <= 5e-2.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.ops import pallas_attn as jpa  # noqa: E402
from audiossl_tpu.ops import pallas_mlp as jpm  # noqa: E402
from audiossl_tpu_torch.methods.atst import method as tcm  # noqa: E402
from audiossl_tpu_torch.methods.atstframe import method as tm  # noqa: E402
from audiossl_tpu_torch.ops import attn_train as tat  # noqa: E402
from audiossl_tpu_torch.ops import block_infer as tbi  # noqa: E402
from audiossl_tpu_torch.ops import layer_norm as tln  # noqa: E402
from audiossl_tpu_torch.ops import mha as tmha  # noqa: E402
from audiossl_tpu_torch.ops import mlp_train as tmt  # noqa: E402
from audiossl_tpu_torch.training import pretrain as tpt  # noqa: E402

B, N, EPS = 4, 24, 1e-6
LENGTHS = np.asarray([16, 24, 9, 0])
DP = np.asarray([1.0, 0.0, 1.25, 1.0], np.float32)
H, D = 2, 8
C_ATTN = H * D
C_MLP, HD = 16, 64
REL_L2 = 5e-3
# parameter names in the order of the halves' arguments after x
PARAMS = {"attn": ("ls", "lb", "w_in", "b_in", "w_out", "b_out"),
          "mlp": ("ls", "lb", "w_in", "b_in", "w_out", "b_out")}


def _inputs(half, seed):
    rng = np.random.RandomState(seed)

    def n(*shape, s=1.0, off=0.0):
        return (rng.randn(*shape) * s + off).astype(np.float32)

    c = C_ATTN if half == "attn" else C_MLP
    hid = 3 * c if half == "attn" else HD
    valid = (np.arange(N)[None, :] < LENGTHS[:, None]).astype(np.float32)
    # JAX kernels [in, out]
    return dict(x=n(B, N, c), valid=valid, ls=n(c, s=0.1, off=1.0),
                lb=n(c, s=0.1), w_in=n(c, hid, s=0.2), b_in=n(hid, s=0.1),
                w_out=n(hid if half == "mlp" else c, c, s=0.2),
                b_out=n(c, s=0.1), w=n(B, N, c))


def _jax(half, p, dtype, quant):
    x = jnp.asarray(p["x"], dtype)
    dp = jnp.asarray(DP)
    valid = jnp.asarray(p["valid"])

    def f(x, ls, lb, w_in, b_in, w_out, b_out):
        if half == "attn":
            return jpa.fused_attn_block(x, valid, dp, ls, lb, w_in, b_in,
                                        w_out, b_out, H, EPS, True, quant)
        return jpm.fused_mlp_block(x, dp, ls, lb, w_in, b_in, w_out, b_out,
                                   EPS, True, quant)

    args = [jnp.asarray(p[k]) for k in PARAMS[half]]
    y = f(x, *args)
    grads = jax.grad(
        lambda *a: jnp.sum(f(*a).astype(jnp.float32) * jnp.asarray(p["w"])),
        argnums=tuple(range(7)))(x, *args)
    grads = [np.asarray(g, np.float32) for g in grads]
    grads[3], grads[5] = grads[3].T, grads[5].T  # torch's [out, in]
    return np.asarray(y, np.float32), grads


def _port(half, p, dtype, quant, plain=False):
    t = lambda a: torch.tensor(np.ascontiguousarray(a))  # noqa: E731
    x = t(p["x"]).to(dtype).requires_grad_()
    params = [t(p["ls"]), t(p["lb"]), t(p["w_in"].T), t(p["b_in"]),
              t(p["w_out"].T), t(p["b_out"])]
    for q in params:
        q.requires_grad_()
    if half == "attn":
        y = tat.fused_attn_block(x, t(p["valid"]), t(DP), *params, H, EPS,
                                 plain=plain, quant=quant)
    else:
        y = tmt.fused_mlp_block(x, t(DP), *params, EPS, plain=plain,
                                quant=quant)
    (y.float() * t(p["w"])).sum().backward()
    f = lambda a: a.detach().float().numpy()  # noqa: E731
    return f(y), [f(x.grad)] + [f(q.grad) for q in params]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "int8dx"])
@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_train_q8_ref_matches_pallas(half, quant, dtype):
    p = _inputs(half, 0)
    jy, jg = _jax(half, p, getattr(jnp, dtype), quant)
    y, g = _port(half, p, getattr(torch, dtype), quant)
    assert _rel(y, jy) <= REL_L2, _rel(y, jy)
    for name, a, b in zip(("dx",) + PARAMS[half], g, jg):
        assert np.all(np.isfinite(a)), name
        assert _rel(a, b) <= REL_L2, (name, _rel(a, b))


@pytest.mark.parametrize("quant", ["int8", "int8dx"])
@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_train_q8_weight_grads_are_rounded_as_jax_returns_them(half, quant):
    """Under a quant mode the JAX backward returns the weight gradients in
    the dequantized weights' dtype (bf16 for bf16 activations) for f32
    masters; the port rounds them the same way."""
    p = _inputs(half, 1)
    _, g = _port(half, p, torch.bfloat16, quant)
    for w in (g[3], g[5]):
        assert w.dtype == np.float32
        np.testing.assert_array_equal(
            w, torch.from_numpy(w).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("quant", ["int8", "int8dx"])
@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_train_q8_tracks_float(half, quant):
    """The port's int8 halves against its float halves, with the inputs of
    ``tests/test_pallas_kernels.py:479-564`` (f32): forward within 2e-2,
    every gradient within 5e-2 (JAX's budget)."""
    if half == "mlp":
        Bm, Nm, c, hd = 2, 16, 32, 128
        rng = np.random.RandomState(7)
        x = rng.randn(Bm, Nm, c).astype(np.float32) * 0.5
        dp = np.asarray([1.0, 1.25], np.float32)
        ls = 1.0 + 0.1 * rng.randn(c).astype(np.float32)
        lb = 0.1 * rng.randn(c).astype(np.float32)
        w1 = rng.randn(c, hd).astype(np.float32) * 0.1
        b1 = 0.05 * rng.randn(hd).astype(np.float32)
        w2 = rng.randn(hd, c).astype(np.float32) * 0.1
        b2 = 0.05 * rng.randn(c).astype(np.float32)
        r = rng.randn(Bm, Nm, c).astype(np.float32)
        args = (ls, lb, w1.T, b1, w2.T, b2)
    else:
        Bm, Hm, Nm, d = 2, 2, 24, 8
        c = Hm * d
        rng = np.random.RandomState(8)
        x = rng.randn(Bm, Nm, c).astype(np.float32) * 0.5
        valid = (np.arange(Nm)[None, :] < np.asarray([24, 10])[:, None])
        dp = np.ones(Bm, np.float32)
        ls = 1.0 + 0.1 * rng.randn(c).astype(np.float32)
        lb = 0.1 * rng.randn(c).astype(np.float32)
        wqkv = rng.randn(c, 3 * c).astype(np.float32) * 0.1
        bqkv = 0.05 * rng.randn(3 * c).astype(np.float32)
        wproj = rng.randn(c, c).astype(np.float32) * 0.1
        bproj = 0.05 * rng.randn(c).astype(np.float32)
        r = rng.randn(Bm, Nm, c).astype(np.float32)
        args = (ls, lb, wqkv.T, bqkv, wproj.T, bproj)

    def run(q):
        ps = [torch.tensor(np.ascontiguousarray(a)).requires_grad_()
              for a in args]
        if half == "mlp":
            y = tmt.fused_mlp_block(torch.from_numpy(x), torch.from_numpy(dp),
                                    *ps, EPS, quant=q)
        else:
            y = tat.fused_attn_block(
                torch.from_numpy(x), torch.from_numpy(valid.astype(
                    np.float32)), torch.from_numpy(dp), *ps, Hm, EPS, quant=q)
        (y * torch.from_numpy(r)).sum().backward()
        return y.detach().numpy(), [p.grad.numpy() for p in ps]

    yf, gf = run(None)
    yq, gq = run(quant)
    assert _rel(yq, yf) < 2e-2, _rel(yq, yf)
    for name, a, b in zip(PARAMS[half], gq, gf):
        assert np.all(np.isfinite(a)), name
        assert _rel(a, b) < 5e-2, (name, _rel(a, b))


# the kernel entry points of the pretraining encoders, by module
_ENTRY_POINTS = {
    "mha_fwd": (tmha, "mha_fwd"), "mha_bwd": (tmha, "mha_bwd"),
    "ln_bwd": (tln, "ln_bwd"),
    "attn_train_fwd": (tat, "attn_train_fwd"),
    "attn_train_bwd": (tat, "attn_train_bwd"),
    "mlp_train_fwd": (tmt, "mlp_train_fwd"),
    "mlp_train_bwd": (tmt, "mlp_train_bwd"),
    "attn_block": (tbi, "attn_block_infer"),
    "mlp_block": (tbi, "mlp_block_infer"),
    "attn_train_fwd_q8": (tat, "attn_train_fwd_q8"),
    "attn_train_bwd_q8dx": (tat, "attn_train_bwd_q8dx"),
    "mlp_train_fwd_q8": (tmt, "mlp_train_fwd_q8"),
    "mlp_train_bwd_q8dx": (tmt, "mlp_train_bwd_q8dx"),
    "attn_block_q8": (tbi, "attn_block_infer_q8"),
    "mlp_block_q8": (tbi, "mlp_block_infer_q8")}

ROUTES = [("bfloat16", "none", "none"), ("bfloat16", "int8", "none"),
          ("bfloat16", "none", "int8"), ("bfloat16", "int8", "int8dx"),
          ("float32", "int8", "int8dx")]


@pytest.mark.parametrize("which", ["frame", "clip"])
@pytest.mark.parametrize("dtype, teacher_quant, student_quant", ROUTES)
def test_quant_options_route_through_the_q8_entry_points(
        monkeypatch, which, dtype, teacher_quant, student_quant):
    """A tiny pretraining step counted at the kernel entry points (their
    plain versions on the CPU). In bf16 ``teacher_quant="int8"`` moves the
    teacher's blocks from K2/K3 to K2q/K3q; ``student_quant="int8"`` the
    student's forward from K4/K5 to K4q/K5q, its backward staying K4/K5;
    ``"int8dx"`` the backward too. In f32 (the K6 route) the options change
    nothing, as in JAX (``models/atst.py:219-311``)."""
    calls = dict.fromkeys(_ENTRY_POINTS, 0)
    for name, (mod, attr) in _ENTRY_POINTS.items():
        def counted(*a, _fn=getattr(mod, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    opt = tpt.OptimizerConfig(learning_rate=5e-4, warmup_steps=0,
                              max_steps=1000, ema=0.99)
    quant = dict(teacher_quant=teacher_quant, student_quant=student_quant)
    if which == "frame":
        method = tm.FrameMethod(tm.FramePretrainConfig(
            arch="tiny", anchor_len=1.0, dtype=dtype, optimizer=opt,
            **quant), device="cpu")
    else:
        method = tcm.ClipMethod(tcm.ClipPretrainConfig(
            arch="tiny", anchor_len=(1.0, 1.0), positive_len=(1.0, 1.0),
            dtype=dtype, optimizer=opt, **quant), device="cpu")
    state = method.init_state(seed=0)
    rng = np.random.RandomState(14)
    wav = torch.from_numpy((rng.randn(4, 20000) * 0.1).astype(np.float32))
    valid = torch.tensor([20000, 18000, 16000, 12000])
    out = method.make_step()(state, {"wav": wav, "valid": valid})
    assert np.isfinite(float(out["loss"]))
    d = method.depth
    if dtype == "float32":
        want = dict(mha_fwd=2 * d, mha_bwd=d, ln_bwd=2 * d + 1)
    else:
        t8 = "_q8" if teacher_quant == "int8" else ""
        s8 = "_q8" if student_quant != "none" else ""
        dx = "_q8dx" if student_quant == "int8dx" else ""
        want = {k: d for k in (f"attn_block{t8}", f"mlp_block{t8}",
                               f"attn_train_fwd{s8}", f"mlp_train_fwd{s8}",
                               f"attn_train_bwd{dx}", f"mlp_train_bwd{dx}")}
        want["ln_bwd"] = 1
    assert calls == {k: want.get(k, 0) for k in calls}, calls
