"""One ATST-Frame pretraining step of the port against the JAX package's
step on the CPU, from the same state and with the same random draws.

Frame-tiny (width 64, 2 blocks, 2 heads, head hidden 128 / out 32), 1 s
anchors (25 tokens), B=4 clips of 1.25 s buffers with valid lengths
[20000, 18000, 16000, 12000] samples (random crop starts, one crop shorter
than the anchor), both views augmented (mixup + freq warp), block masks,
f32, ``drop_path_rate=0``. The JAX step's own draws (crop starts, mixup
weights and partners, freq-warp boxes, mask uniforms) are rebuilt from
its keys and handed to the port. Tolerances: loss rel 1e-5; every
gradient leaf, the Adam moments, and both branches' BatchNorm statistics
rel L2 1e-4; the parameter updates p' - p rel L2 1e-3 (Adam's first step
divides each element by its own scale, which magnifies the f32
rounding of gradients below a few eps, so those elements are held to a
tenth of a step instead); the teacher's values rel L2 1e-6. The final
LayerNorm's bias gets no gradient in exact arithmetic (the projector's
BatchNorm cancels any constant added to its input), so both sides hold
only rounding noise there: that leaf is held to a vanishing gradient.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import traverse_util  # noqa: E402

from audiossl_tpu.methods.atstframe import method as jm  # noqa: E402
from audiossl_tpu.ops import pallas_block as jpb  # noqa: E402
from audiossl_tpu.training import pretrain as jpt  # noqa: E402
from audiossl_tpu_torch.compat import checkpoint as ck  # noqa: E402
from audiossl_tpu_torch.methods.atstframe import method as tm  # noqa: E402
from audiossl_tpu_torch.models.transformer import (  # noqa: E402
    Block,
    drop_path_multipliers,
)
from audiossl_tpu_torch.methods.atst import method as tcm  # noqa: E402
from audiossl_tpu_torch.ops import attn_train as tat  # noqa: E402
from audiossl_tpu_torch.ops import block_infer as tbi  # noqa: E402
from audiossl_tpu_torch.ops import layer_norm as tln  # noqa: E402
from audiossl_tpu_torch.ops import mha as tmha  # noqa: E402
from audiossl_tpu_torch.ops import mlp_train as tmt  # noqa: E402
from audiossl_tpu_torch.training import pretrain as tpt  # noqa: E402

B, L = 4, 20000
VALID = np.asarray([20000, 18000, 16000, 12000], np.int32)
OPT = dict(learning_rate=5e-4, warmup_steps=0, max_steps=1000, ema=0.99)
ZERO_GRAD = "encoder.norm_frame.bias"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_method():
    cfg = jm.FramePretrainConfig(arch="tiny", anchor_len=1.0,
                                 optimizer=jpt.OptimizerConfig(**OPT))
    m = jm.FrameMethod(cfg)
    m.student = m.student.clone(
        encoder=m.student.encoder.clone(drop_path_rate=0.0))
    m.teacher = m.teacher.clone(
        encoder=m.teacher.encoder.clone(drop_path_rate=0.0))
    return m


def _jax_draws(step_rng, cfg):
    """The random numbers of jm.FrameMethod.forward_loss, from its keys."""
    k_aug, _, _ = jax.random.split(step_rng, 3)
    k_crop, k_v1, k_v2, k_mask = jax.random.split(k_aug, 4)
    f = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    mix, rrc = [], []
    for kv in (k_v1, k_v2):
        k_mix, k_rrc = jax.random.split(kv)
        k1, k2 = jax.random.split(k_mix)
        a = np.float32(cfg.mixup_ratio) * np.asarray(
            jax.random.uniform(k1, (B, 1, 1)))[:, 0, 0]
        shift = jax.random.randint(k2, (B,), 1, max(B, 2))
        mix.append((f(a), f(shift).long()))
        r1, _, r3, _ = jax.random.split(k_rrc, 4)
        rrc.append((f(jax.random.uniform(r1, (B,))),
                    f(jax.random.uniform(r3, (B,)))))
    k_round, k_starts = jax.random.split(k_mask)
    mask = {"u_round": f(jax.random.uniform(k_round, (B,))),
            "u_starts": f(jax.random.uniform(k_starts,
                                             (B, cfg.num_patches)))}
    return tm.StepDraws(crop=f(jax.random.uniform(k_crop, (B,))),
                        mix=tuple(mix), rrc=tuple(rrc), mask=mask,
                        student_dp=None, teacher_dp=None)


@pytest.fixture(scope="module")
def one_step():
    rng = np.random.RandomState(0)
    wav = (rng.randn(B, L) * 0.1).astype(np.float32)
    for i, v in enumerate(VALID):
        wav[i, v:] = 0.0
    batch = {"wav": jnp.asarray(wav), "valid": jnp.asarray(VALID)}
    m = _jax_method()
    state = m.init_state(jax.random.PRNGKey(0))
    # move norms, biases and BN affines off their init values
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))

    def nudge(path, p):
        if path[-1] in ("bias", "scale"):
            return p + 0.05 * jax.random.normal(next(keys), p.shape)
        return p

    params = traverse_util.unflatten_dict(
        {k: nudge(k, v) for k, v in
         traverse_util.flatten_dict(state.params).items()})
    state = state._replace(
        params=params,
        teacher_params=jpt.copy_into_structure(state.teacher_params, params))

    _, step_rng = jax.random.split(state.rng)

    def loss_fn(p):
        def student_apply(*a, rngs=None, **kw):
            return m.student.apply(
                {"params": p, "batch_stats": state.batch_stats}, *a,
                train=True, mutable=["batch_stats"], rngs=rngs, **kw)

        def teacher_apply(*a, rngs=None, **kw):
            return m.teacher.apply(
                {"params": state.teacher_params,
                 "batch_stats": state.teacher_batch_stats}, *a, train=True,
                mutable=["batch_stats"], rngs=rngs, **kw)

        return m.forward_loss(student_apply, teacher_apply, batch, step_rng)

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    new_state, metrics = jax.jit(m.make_step())(state, batch)

    pcfg = tm.FramePretrainConfig(arch="tiny", anchor_len=1.0,
                                  drop_path_rate=0.0,
                                  optimizer=tpt.OptimizerConfig(**OPT))
    method = tm.FrameMethod(pcfg, device="cpu")
    pstate = ck.pretrain_state_from_flax(state, method,
                                         torch.Generator().manual_seed(0))
    before = {k: v.detach().clone()
              for k, v in pstate.student.state_dict().items()}
    t_before = {k: v.detach().clone()
                for k, v in pstate.teacher.state_dict().items()}
    step = method.make_step()
    out = step(pstate, {"wav": torch.from_numpy(wav),
                        "valid": torch.from_numpy(VALID)},
               _jax_draws(step_rng, m.cfg))
    return dict(jax_loss=float(loss), jax_grads=grads, jax_new=new_state,
                jax_metrics=metrics, port=pstate, port_out=out,
                before=before, t_before=t_before)


def test_step_loss_matches_jax(one_step):
    got = float(one_step["port_out"]["loss"])
    want = one_step["jax_loss"]
    assert float(one_step["jax_metrics"]["loss"]) == pytest.approx(want,
                                                                   rel=1e-6)
    assert got == pytest.approx(want, rel=1e-5)
    for k in ("std_frm_stu", "std_frm_tea"):
        assert float(one_step["port_out"][k]) == pytest.approx(
            float(one_step["jax_metrics"][k]), rel=1e-5)


def test_step_gradients_match_jax(one_step):
    want = ck.branch_state_from_flax(ck._tree_np(one_step["jax_grads"]))
    params = dict(one_step["port"].student.named_parameters())
    assert set(want) == set(params)
    gmax = max(float(v.norm()) for v in want.values())
    bad = []
    for k, p in params.items():
        if k == ZERO_GRAD:
            assert max(float(p.grad.norm()), float(want[k].norm())) < 1e-6 * gmax
        elif _rel(p.grad.numpy(), want[k].numpy()) >= 1e-4:
            bad.append((k, _rel(p.grad.numpy(), want[k].numpy())))
    assert not bad, bad


def test_step_adam_moments_match_jax(one_step):
    new = one_step["jax_new"]
    mu, nu, count = ck.opt_state_from_flax(new.opt_state._replace(
        mu=ck._tree_np(new.opt_state.mu), nu=ck._tree_np(new.opt_state.nu)))
    port = one_step["port"]
    assert port.count == count == 1 and port.step == int(new.step) == 1
    mmax = max(float(v.norm()) for v in mu.values())
    bad = []
    for k in mu:
        if k == ZERO_GRAD:  # 0.1 g and 0.001 g^2 of rounding noise
            assert max(float(port.mu[k].norm()), float(mu[k].norm())) < (
                1e-6 * mmax)
            continue
        for name, a, b in (("mu", port.mu[k], mu[k]), ("nu", port.nu[k], nu[k])):
            if _rel(a.numpy(), b.numpy()) >= 1e-4:
                bad.append((name, k, _rel(a.numpy(), b.numpy())))
    assert not bad, bad


@pytest.mark.parametrize("branch", ["student", "teacher"])
def test_step_updates_match_jax(one_step, branch):
    """Parameter updates p' - p of the student (AdamW) and the teacher
    (EMA), and both branches' BatchNorm running statistics."""
    new = one_step["jax_new"]
    if branch == "student":
        want = ck.branch_state_from_flax(ck._tree_np(new.params),
                                         ck._tree_np(new.batch_stats))
        got, before = one_step["port"].student, one_step["before"]
    else:
        want = ck.branch_state_from_flax(
            ck._tree_np(new.teacher_params),
            ck._tree_np(new.teacher_batch_stats))
        got, before = one_step["port"].teacher, one_step["t_before"]
    sd = got.state_dict()
    assert set(sd) == set(want)
    grads = ck.branch_state_from_flax(ck._tree_np(one_step["jax_grads"]))
    lr, ema = OPT["learning_rate"], OPT["ema"]
    bad = []
    for k, v in sd.items():
        if "running" in k:
            assert not torch.equal(v, before[k]), k
            err = _rel(v.numpy(), want[k].numpy())
            if err >= 1e-4:
                bad.append((k, err))
            continue
        if branch == "teacher":
            # t' = m t + (1 - m) p' moves each value by ~(1 - m) lr, close
            # to f32's spacing: held on the values, and it must move
            assert not torch.equal(v, before[k]), k
            if k == ZERO_GRAD:
                assert np.abs(v.numpy() - want[k].numpy()).max() <= (
                    0.1 * lr * (1.0 - ema))
                continue
            err = _rel(v.numpy(), want[k].numpy())
            if err >= 1e-6:
                bad.append((k, err))
            continue
        d_got = (v - before[k]).numpy()
        d_want = want[k].numpy() - before[k].numpy()
        # Adam's first step maps g to about g / (|g| + eps): below a few
        # eps it divides g's f32 rounding by eps, so those elements are
        # held to a tenth of a step and the rest to rel L2 1e-3
        assert np.abs(d_got - d_want).max() <= 0.1 * lr, k
        if k == ZERO_GRAD:
            continue
        big = np.abs(grads[k].numpy()) >= 10 * tpt.OptimizerConfig().eps
        if _rel(d_got[big], d_want[big]) >= 1e-3:
            bad.append((k, _rel(d_got[big], d_want[big])))
    assert not bad, bad


def test_three_steps_on_a_repeated_batch_lower_the_loss():
    cfg = tm.FramePretrainConfig(
        arch="tiny", anchor_len=1.0,
        optimizer=tpt.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                      max_steps=100))
    method = tm.FrameMethod(cfg, device="cpu", seed=3)
    state = method.init_state(seed=4)
    wav = torch.from_numpy(
        (np.random.RandomState(5).randn(B, 16000) * 0.1).astype(np.float32))
    batch = {"wav": wav, "valid": torch.full((B,), 16000)}
    draws = method.draw(torch.Generator().manual_seed(6), B)
    assert draws.student_dp is not None and draws.teacher_dp is not None
    step = method.make_step()
    t0 = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    losses = [float(step(state, batch, draws)["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    assert losses[0] > losses[1] > losses[2], losses
    moved = [k for k, v in state.teacher.state_dict().items()
             if not torch.equal(v, t0[k])]
    assert "encoder.blocks.1.attn.qkv.weight" in moved


def test_teacher_drop_path_matches_pallas_encoder_blocks_infer():
    """The train-mode teacher's stochastic depth: multipliers drawn as
    ``pallas_block.encoder_blocks_infer`` draws them ([depth, 2, B]
    uniforms, rate ramped over depth) give the same block outputs. N=128,
    so the JAX version pads nothing."""
    rng = np.random.RandomState(7)
    C, H, depth, Bt, N = 64, 2, 2, 8, 128
    model = torch.nn.Module()
    model.blocks = torch.nn.ModuleList(Block(C, H) for _ in range(depth))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                (rng.randn(*p.shape) * 0.1).astype(np.float32)))
    flax_params = {}
    for i, blk in enumerate(model.blocks):
        w = lambda lin: lin.weight.detach().numpy().T  # noqa: E731
        b = lambda t: t.detach().numpy()  # noqa: E731
        flax_params[f"blocks_{i}"] = {
            "norm1": {"scale": b(blk.norm1.weight), "bias": b(blk.norm1.bias)},
            "norm2": {"scale": b(blk.norm2.weight), "bias": b(blk.norm2.bias)},
            "attn": {"qkv": {"kernel": w(blk.attn.qkv)},
                     "proj": {"kernel": w(blk.attn.proj),
                              "bias": b(blk.attn.proj.bias)}},
            "mlp": {"fc1": {"kernel": w(blk.mlp.fc1), "bias": b(blk.mlp.fc1.bias)},
                    "fc2": {"kernel": w(blk.mlp.fc2),
                            "bias": b(blk.mlp.fc2.bias)}}}
    x = rng.randn(Bt, N, C).astype(np.float32)
    lengths = np.asarray([128, 100, 77, 5, 128, 64, 1, 128], np.int32)
    key = jax.random.PRNGKey(1)  # drops 4 of the 16 branches of block 1
    want, _ = jpb.encoder_blocks_infer(
        flax_params, jnp.asarray(x), jnp.asarray(lengths), H, depth,
        drop_path_rate=0.1, rng=key, interpret=True)
    dps = drop_path_multipliers(
        torch.from_numpy(np.asarray(jax.random.uniform(key, (depth, 2, Bt)))),
        0.1)
    assert float((dps == 0).sum()) > 0  # some branch is dropped
    assert torch.all((dps == 1) | (dps == 0) | (dps == np.float32(1 / 0.9)))
    with torch.no_grad():
        got, _ = tbi.encoder_blocks_infer(model.blocks, torch.from_numpy(x),
                                          torch.from_numpy(lengths), H,
                                          dps=dps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_pretrain_state_bridge_covers_the_whole_branch():
    """Every parameter and BatchNorm statistic of the JAX branches has its
    place in the port's branches, and the teacher's encoder keeps the
    serving names."""
    m = _jax_method()
    state = m.init_state(jax.random.PRNGKey(0))
    sd = ck.branch_state_from_flax(ck._tree_np(state.params),
                                   ck._tree_np(state.batch_stats))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        (state.params, state.batch_stats)))
    assert sum(v.numel() for v in sd.values()) == n_jax
    method = tm.FrameMethod(dataclasses.replace(
        tm.FramePretrainConfig(arch="tiny", anchor_len=1.0)), device="cpu")
    assert set(method.student.state_dict()) == set(sd)
    t_sd = ck.branch_state_from_flax(ck._tree_np(state.teacher_params),
                                     ck._tree_np(state.teacher_batch_stats))
    assert set(method.teacher.state_dict()) == set(t_sd)
    enc = {k[len("encoder."):] for k in t_sd if k.startswith("encoder.")}
    from audiossl_tpu_torch.models.atst import frame_ast_tiny
    assert enc == set(frame_ast_tiny(spec_w=101, device="cpu").state_dict())


def test_trained_teacher_loads_into_load_model(tmp_path):
    """The teacher branch's encoder keeps the serving names: saved under a
    reference checkpoint's ``model.teacher.`` prefix it loads into
    ``embedding.load_model`` as it is and embeds."""
    from audiossl_tpu_torch.embedding import get_scene_embedding, load_model

    method = tm.FrameMethod(tm.FramePretrainConfig(arch="tiny"),
                            device="cpu", seed=1)
    sd = {f"model.teacher.{k}": v for k, v in
          method.teacher.state_dict().items() if k.startswith("encoder.")}
    path = str(tmp_path / "teacher.ckpt")
    torch.save({"state_dict": sd, "hyper_parameters": {"arch": "tiny"}}, path)
    model = load_model(path, device="cpu")
    enc = method.teacher.encoder.state_dict()
    for k, v in model.encoder.state_dict().items():
        assert torch.equal(v, enc[k]), k
    emb = get_scene_embedding(np.zeros((1, 16000), np.float32), model)
    assert emb.shape == (1, 2 * 64)  # both blocks of frame-tiny
    assert bool(torch.isfinite(emb).all())


def _module_vs_kernel_step(dtype):
    """One frame-tiny step, drop-path included, on the module path and on
    the kernel route of ``dtype`` (plain versions on the CPU), from the
    same state and draws: (loss, gradients, teacher state) of each."""
    def run(fused):
        cfg = tm.FramePretrainConfig(arch="tiny", anchor_len=1.0,
                                     fused_attention=fused, dtype=dtype,
                                     optimizer=tpt.OptimizerConfig(**OPT))
        method = tm.FrameMethod(cfg, device="cpu", seed=11)
        state = method.init_state(seed=0)
        wav = torch.from_numpy((np.random.RandomState(12).randn(B, L)
                                * 0.1).astype(np.float32))
        draws = method.draw(torch.Generator().manual_seed(13), B)
        assert bool((draws.student_dp == 0).any())  # a dropped branch
        out = method.make_step()(
            state, {"wav": wav, "valid": torch.from_numpy(VALID)}, draws)
        grads = {k: p.grad.clone()
                 for k, p in state.student.named_parameters()}
        return float(out["loss"]), grads, state.teacher.state_dict()

    return run(True), run(False)


def test_module_path_step_matches_block_kernel_path():
    """``fused_attention=False`` runs both encoders on the module path
    (additive -10000 mask, ``nn.LayerNorm``, autograd, stochastic depth on
    the residual branches); from the same state and draws, drop-path
    included, it computes the step of the f32 kernel route (K6 and
    LayerNormPG, plain versions on the CPU) in f32."""
    (loss_k, grads_k, teacher_k), (loss_m, grads_m, teacher_m) = \
        _module_vs_kernel_step("float32")
    assert loss_m == pytest.approx(loss_k, rel=1e-5)
    for k, g in grads_k.items():
        if k != ZERO_GRAD:
            assert _rel(grads_m[k].numpy(), g.numpy()) < 1e-4, k
    for k, v in teacher_k.items():
        if "running" in k:
            assert _rel(teacher_m[k].numpy(), v.numpy()) < 1e-4, k


def test_module_path_step_matches_block_kernel_path_bf16():
    """The bf16 twin: the kernel route is then K4/K5 for the student and
    K2/K3 for the teacher (plain versions on the CPU). Both paths round to
    bf16, at different points (the module path after every operation), so
    they are held to the loss within 1e-2 relative, every gradient leaf to
    cosine >= 0.98 and the BatchNorm statistics within 1e-2: at width 64
    and 25 tokens the rounding weighs more than at base width, where the
    card holds the kernel step to its plain step at 0.99."""
    (loss_k, grads_k, teacher_k), (loss_m, grads_m, teacher_m) = \
        _module_vs_kernel_step("bfloat16")
    assert loss_m == pytest.approx(loss_k, rel=1e-2)
    for k, g in grads_k.items():
        if k != ZERO_GRAD:
            cos = torch.nn.functional.cosine_similarity(
                grads_m[k].double().flatten(), g.double().flatten(), dim=0)
            assert float(cos) >= 0.98, (k, float(cos))
    for k, v in teacher_k.items():
        if "running" in k:
            assert _rel(teacher_m[k].numpy(), v.numpy()) < 1e-2, k


# the kernel entry points of the pretraining encoders, by module
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
@pytest.mark.parametrize("which", ["frame", "clip"])
def test_step_routes_blocks_by_dtype(monkeypatch, which, dtype):
    """The route of the JAX encoders (``models/atst.py:219-272``): in f32
    both encoders' blocks take the standalone MHA (K6) and LayerNormPG (K8
    for the student's backward: two norms per block and the final norm),
    never the bf16-only block kernels K4/K5/K2/K3; in bf16 the student
    takes K4/K5 and the teacher K2/K3, and the final norm stays LayerNormPG
    (``models/atst.py:141`` picks it by the flag alone). Counted at the
    kernel entry points, which take their plain versions on the CPU."""
    calls = dict.fromkeys(_ENTRY_POINTS, 0)
    for name, (mod, attr) in _ENTRY_POINTS.items():
        def counted(*a, _fn=getattr(mod, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    opt = tpt.OptimizerConfig(**OPT)
    if which == "frame":
        method = tm.FrameMethod(tm.FramePretrainConfig(
            arch="tiny", anchor_len=1.0, dtype=dtype, optimizer=opt),
            device="cpu")
    else:
        method = tcm.ClipMethod(tcm.ClipPretrainConfig(
            arch="tiny", anchor_len=(1.0, 1.0), positive_len=(1.0, 1.0),
            dtype=dtype, optimizer=opt), device="cpu")
    state = method.init_state(seed=0)
    wav = torch.from_numpy((np.random.RandomState(14).randn(B, L)
                            * 0.1).astype(np.float32))
    out = method.make_step()(state, {"wav": wav,
                                     "valid": torch.from_numpy(VALID)})
    assert np.isfinite(float(out["loss"]))
    d = method.depth
    if dtype == "float32":
        want = dict(mha_fwd=2 * d, mha_bwd=d, ln_bwd=2 * d + 1)
    else:
        want = {k: d for k in ("attn_train_fwd", "attn_train_bwd",
                               "mlp_train_fwd", "mlp_train_bwd",
                               "attn_block", "mlp_block")}
        want["ln_bwd"] = 1
    assert calls == {k: want.get(k, 0) for k in calls}, calls
