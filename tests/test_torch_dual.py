"""The port's dual method against the JAX package's on the CPU.

Tiny config (``arch="tiny"``: two encoders of width 64, 2 blocks, 2
heads), 0.5 s anchors (51 frames, G = 3 groups of 16 frames, 12 tokens a
branch), expanders of 64 to 16, ``fused_attention=True`` on both sides
(JAX's f32 encoders then use ``LayerNormPG``; the port's take K6 and K8,
their plain versions on the CPU). The JAX params (norms and biases moved
off their init values) go into the port through
``compat.checkpoint.dual_state_from_flax``; JAX's block-mask uniforms,
crop uniforms and drop-path uniforms (its ``drop_path``,
``models/transformer.py:160``, handed fixed keys) are rebuilt and handed
to the port. Tolerances: the loss and each of the seven aux values rel
1e-5; each leaf's gradient rel L2 1e-4; after one step the parameters
and both Adam moments rtol 1e-5, atol 2e-5; the bf16 route (the port's
block kernels K4/K5 in their plain versions against JAX's bf16 module
route on the CPU) loss rel 1e-2.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import traverse_util  # noqa: E402

from audiossl_tpu.methods.dual import method as jm  # noqa: E402
from audiossl_tpu.models import transformer as jtr  # noqa: E402
from audiossl_tpu.training import pretrain as jpt  # noqa: E402
from audiossl_tpu_torch.compat import checkpoint as ck  # noqa: E402
from audiossl_tpu_torch.methods.dual import method as tm  # noqa: E402
from audiossl_tpu_torch.ops import attn_train as tat  # noqa: E402
from audiossl_tpu_torch.ops import block_infer as tbi  # noqa: E402
from audiossl_tpu_torch.ops import layer_norm as tln  # noqa: E402
from audiossl_tpu_torch.ops import mha as tmha  # noqa: E402
from audiossl_tpu_torch.ops import mlp_train as tmt  # noqa: E402
from audiossl_tpu_torch.training import pretrain as tpt  # noqa: E402

KW = dict(arch="tiny", anchor_len=0.5, expander_dim=64, out_dim=16,
          fused_attention=True)
OPT = dict(learning_rate=5e-4, warmup_steps=0, max_steps=1000)
B, L, DEPTH = 4, 12000, 2
VALID = np.asarray([12000, 10000, 8000, 6000], np.int32)
AUX = ("loss_mel_patch", "loss_mel_frame", "loss_dual", "loss_uniform_patch",
       "loss_uniform_frame", "std_patch", "std_frame")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_method(dtype="float32"):
    cfg = jm.DualConfig(dtype=dtype, optimizer=jpt.OptimizerConfig(**OPT),
                        **KW)
    m = jm.DualMethod(cfg)
    state = jax.jit(m.init_state)(jax.random.PRNGKey(0))
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))

    def nudge(path, p):
        if path[-1] in ("bias", "scale"):
            return p + 0.05 * jax.random.normal(next(keys), p.shape)
        return p

    params = traverse_util.unflatten_dict(
        {k: nudge(k, v) for k, v in
         traverse_util.flatten_dict(state.params).items()})
    return m, state._replace(params=params)


@pytest.fixture(scope="module")
def jax_f32():
    return _jax_method()


def _port(dtype="float32"):
    cfg = tm.DualConfig(dtype=dtype, optimizer=tpt.OptimizerConfig(**OPT),
                        **KW)
    return tm.DualMethod(cfg, device="cpu", seed=5)


def _record_drop_path(monkeypatch, seed):
    """JAX's ``drop_path`` handed fixed keys; returns the list its calls
    append (rate, key, shape, dtype) to."""
    calls = []
    keys = iter(np.asarray(jax.random.split(jax.random.PRNGKey(seed), 64)))
    orig = jtr.drop_path

    def drop_path(x, rate, deterministic, key):
        k = next(keys)
        calls.append((rate, k, (x.shape[0],) + (1,) * (x.ndim - 1), x.dtype))
        return orig(x, rate, deterministic, k)

    monkeypatch.setattr(jtr, "drop_path", drop_path)
    return calls


def _multipliers(calls):
    """The keep multipliers [depth, 2, B] of each encoder (patchnet, then
    framenet: JAX's call order) that JAX's recorded calls applied; block 0
    has rate 0 and draws nothing."""
    per = 2 * (DEPTH - 1)
    assert len(calls) == 2 * per
    out = []
    for e in range(2):
        m = np.ones((DEPTH, 2, B), np.float32)
        for j, (rate, k, shape, dtype) in enumerate(calls[e * per:
                                                          (e + 1) * per]):
            i, branch = 1 + j // 2, j % 2
            assert rate == pytest.approx(tm.DROP_PATH_RATE * i / (DEPTH - 1))
            keep = 1.0 - rate
            drop = jnp.floor(keep + jax.random.uniform(k, shape, dtype=dtype))
            m[i, branch] = (np.asarray(drop, np.float32).reshape(-1)
                            / np.float32(keep))
        out.append(torch.from_numpy(m))
    return out


def _mask_groups(seed=2):
    rng = np.random.RandomState(seed)
    m = rng.rand(B, 3) < 0.5
    m[0] = [True, False, True]
    m[1] = False  # a clip with no masked group
    return m


def _jax_loss_grads(m, params, mel, mask, monkeypatch, seed=3):
    calls = _record_drop_path(monkeypatch, seed)

    def loss_fn(p):
        return m.model.apply({"params": p}, jnp.asarray(mel),
                             jnp.asarray(mask), deterministic=False,
                             rngs={"droppath": jax.random.PRNGKey(0)})

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return float(loss), {k: float(v) for k, v in aux.items()}, grads, \
        _multipliers(calls)


def test_loss_aux_and_gradients_match_jax(jax_f32, monkeypatch):
    m, state = jax_f32
    mel = np.random.RandomState(4).randn(B, 64, 51).astype(np.float32)
    mask = _mask_groups()
    loss, aux, grads, (dp_p, dp_f) = _jax_loss_grads(
        m, state.params, mel, mask, monkeypatch)
    assert float((dp_p == 0).sum() + (dp_f == 0).sum()) > 0  # a drop
    model = _port().model
    model.load_state_dict(ck.dual_state_from_flax(ck._tree_np(state.params)))
    got, got_aux = model(torch.from_numpy(mel), torch.from_numpy(mask),
                         dp_p, dp_f)
    got.backward()
    assert float(got.detach()) == pytest.approx(loss, rel=1e-5)
    assert set(got_aux) == set(aux) == set(AUX)
    for k in AUX:
        assert float(got_aux[k]) == pytest.approx(aux[k], rel=1e-5), k
    want = ck.dual_state_from_flax(ck._tree_np(grads))
    params = dict(model.named_parameters())
    assert set(params) == set(want)
    bad = [(k, err) for k, p in params.items()
           if (err := _rel(p.grad.numpy(), want[k].numpy())) > 1e-4]
    assert not bad, bad


def test_bridge_places_every_leaf(jax_f32):
    _, state = jax_f32
    sd = ck.dual_state_from_flax(ck._tree_np(state.params))
    model = _port().model
    assert set(sd) == set(model.state_dict())
    assert "framenet.norm_frame.weight" in sd
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(state.params))
    assert sum(v.numel() for v in sd.values()) == n_jax
    params = ck._tree_np(state.params)
    for bad in ({**params, "cls_head": {}},
                {**params, "patch_expander": {**params["patch_expander"],
                                              "ln2": {}}}):
        with pytest.raises(KeyError, match="no place"):
            ck.dual_state_from_flax(bad)


def test_step_matches_jax(jax_f32, monkeypatch):
    """One ``DualMethod`` step from JAX's state with JAX's crop, block-mask
    and drop-path draws against JAX's ``step_fn``."""
    m, state = jax_f32
    rng = np.random.RandomState(0)
    wav = (rng.randn(B, L) * 0.1).astype(np.float32)
    for i, v in enumerate(VALID):
        wav[i, v:] = 0.0
    calls = _record_drop_path(monkeypatch, 5)
    new, metrics = jax.jit(m.make_step())(
        state, {"wav": jnp.asarray(wav), "valid": jnp.asarray(VALID)})
    dp_p, dp_f = _multipliers(calls)
    _, k_crop, k_mask, _ = jax.random.split(state.rng, 4)
    k_round, k_starts = jax.random.split(k_mask)
    f = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    G = m.cfg.n_groups
    draws = tm.DualDraws(
        crop=f(jax.random.uniform(k_crop, (B,))),
        mask={"u_round": f(jax.random.uniform(k_round, (B,))),
              "u_starts": f(jax.random.uniform(k_starts, (B, G)))},
        patch_dp=dp_p, frame_dp=dp_f)
    method = _port()
    pstate = ck.model_state_from_flax(state, method,
                                      torch.Generator().manual_seed(0))
    assert pstate.teacher is None
    out = method.make_step()(pstate, {"wav": torch.from_numpy(wav),
                                      "valid": torch.from_numpy(VALID)},
                             draws)
    assert set(out) == {"loss", "lr", "wd", *AUX}
    for k in ("loss", *AUX):
        assert float(out[k]) == pytest.approx(float(metrics[k]),
                                              rel=1e-5), k
    assert pstate.step == int(new.step) == 1
    assert pstate.count == int(new.opt_state.count) == 1
    want = {"params": ck.dual_state_from_flax(ck._tree_np(new.params)),
            "mu": ck.dual_state_from_flax(ck._tree_np(new.opt_state.mu)),
            "nu": ck.dual_state_from_flax(ck._tree_np(new.opt_state.nu))}
    got = {"params": dict(pstate.student.named_parameters()),
           "mu": pstate.mu, "nu": pstate.nu}
    for group, w in want.items():
        for k, v in w.items():
            np.testing.assert_allclose(got[group][k].detach().numpy(),
                                       v.numpy(), rtol=1e-5, atol=2e-5,
                                       err_msg=f"{group} {k}")


def test_variance_loss_matches_jax_on_a_known_variance():
    """Columns of +-s_j about a mean: the population variance is s_j^2
    (an unbiased estimate would give s_j^2 n / (n - 1))."""
    n = 10
    s = np.asarray([0.25, 0.5, 1.0, 2.0], np.float32)
    z = np.where(np.arange(n)[:, None] % 2 == 0, 3.0 + s, 3.0 - s).astype(
        np.float32)
    lu, std = tm.variance_loss(torch.from_numpy(z))
    jlu, jstd = jm.variance_loss(jnp.asarray(z))
    want_std = np.sqrt(s.astype(np.float64) ** 2 + 1e-4)
    assert float(std) == pytest.approx(want_std.mean(), rel=1e-6)
    assert float(lu) == pytest.approx(np.maximum(1 - want_std, 0).mean(),
                                      rel=1e-6)
    assert float(lu) == pytest.approx(float(jlu), rel=1e-6)
    assert float(std) == pytest.approx(float(jstd), rel=1e-6)


def test_frame_count_rule_refuses_where_jax_fails():
    """At 6.0 s (601 frames: the frame branch's 150 tokens against the
    masks' 148) JAX's model fails in a broadcast; the port's config raises
    a ValueError naming the rule. 0.5 s (51 frames) and 6.4 s (641) pass
    both."""
    jcfg = jm.DualConfig(arch="tiny", anchor_len=6.0, expander_dim=32,
                         out_dim=16, fused_attention=False)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.jit(jm.DualMethod(jcfg).init_state)(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=r"T mod 16 must be below 4"):
        tm.DualConfig(arch="tiny", anchor_len=6.0)
    with pytest.raises(ValueError, match="601 frames"):
        tm.DualConfig()  # JAX's default anchor_len
    for a in (0.5, 6.4):
        cfg = tm.DualConfig(arch="tiny", anchor_len=a)
        assert cfg.out_frames // 4 == 4 * cfg.n_groups


def test_bf16_block_kernel_route_matches_jax_bf16(monkeypatch):
    """The port's bf16 encoders run the trainable block kernels K4/K5
    (plain versions here), JAX's on the CPU its bf16 module route; from
    the same params, mask and drop-path multipliers the losses agree
    within bf16 rounding."""
    m, state = _jax_method("bfloat16")
    mel = np.random.RandomState(6).randn(B, 64, 51).astype(np.float32)
    mask = _mask_groups(7)
    loss, _, _, (dp_p, dp_f) = _jax_loss_grads(m, state.params, mel, mask,
                                               monkeypatch, seed=8)
    model = _port("bfloat16").model
    model.load_state_dict(ck.dual_state_from_flax(ck._tree_np(state.params)))
    assert model.patchnet._route == model.framenet._route == "block_kernels"
    got, _ = model(torch.from_numpy(mel), torch.from_numpy(mask), dp_p, dp_f)
    assert float(got) == pytest.approx(loss, rel=1e-2)


# the kernel entry points of the encoders, by module
_ENTRY_POINTS = {
    "mha_fwd": (tmha, "mha_fwd"), "mha_bwd": (tmha, "mha_bwd"),
    "ln_bwd": (tln, "ln_bwd"),
    "attn_train_fwd": (tat, "attn_train_fwd"),
    "attn_train_bwd": (tat, "attn_train_bwd"),
    "mlp_train_fwd": (tmt, "mlp_train_fwd"),
    "mlp_train_bwd": (tmt, "mlp_train_bwd"),
    "attn_block": (tbi, "attn_block_infer"),
    "mlp_block": (tbi, "mlp_block_infer")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_routes_blocks_by_dtype(monkeypatch, dtype):
    """A step's kernel entry points (plain versions on the CPU): in f32
    both encoders' blocks take K6 forward and backward and their norms
    K8 (two a block and the final norm); in bf16 K4/K5 forward and
    backward and K8 for the final norms; never the inference kernels."""
    calls = dict.fromkeys(_ENTRY_POINTS, 0)
    for name, (mod, attr) in _ENTRY_POINTS.items():
        def counted(*a, _fn=getattr(mod, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    method = _port(dtype)
    state = method.init_state(seed=0)
    wav = torch.from_numpy((np.random.RandomState(9).randn(B, L)
                            * 0.1).astype(np.float32))
    out = method.make_step()(state, {"wav": wav,
                                     "valid": torch.from_numpy(VALID)})
    assert np.isfinite(float(out["loss"]))
    n = 2 * method.depth  # blocks of both encoders
    if dtype == "float32":
        want = dict(mha_fwd=n, mha_bwd=n, ln_bwd=2 * n + 2)
    else:
        want = {k: n for k in ("attn_train_fwd", "attn_train_bwd",
                               "mlp_train_fwd", "mlp_train_bwd")}
        want["ln_bwd"] = 2
    assert calls == {k: want.get(k, 0) for k in calls}, calls
