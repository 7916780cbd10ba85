"""The port's ATST-Clip pieces and one whole ATST-Clip pretraining step
against the JAX package's on the CPU.

The augmentations take JAX's draws, rebuilt from its keys (atol 1e-5);
``clip_byol_loss`` and the clip encoder's forward (``ast_tiny`` through the
checkpoint bridge, the module path and the K6/LayerNormPG route) are held
to 1e-5 relative and 2e-5 absolute.

The step: clip-tiny (width 64, 2 blocks, 2 heads, heads 128 -> 32), f32,
``fused_attention=True`` (K6 and LayerNormPG in the port; the JAX package
on the CPU runs the same route with its einsum attention), drop-path 0,
B=4 clips of 1.25 s buffers with valid lengths [20000, 18000, 16000,
12000], both views augmented (mixup + RandomResizeCrop on a 1.5x canvas).
One case with fixed 1 s crops, one with crop lengths drawn in [0.6, 1] s.
Tolerances are the frame step's (``test_torch_pretrain.py``): loss rel
1e-5; every gradient, Adam's moments and the BatchNorm statistics rel L2
1e-4; the updates rel L2 1e-3; the teacher 1e-6. The final LayerNorm's
bias has no gradient in exact arithmetic (the projector's BatchNorm cancels
a constant shift): it is held to a vanishing gradient.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import traverse_util  # noqa: E402

from audiossl_tpu.methods.atst import method as jm  # noqa: E402
from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models import byol as jbyol  # noqa: E402
from audiossl_tpu.ops import interpolate as jip  # noqa: E402
from audiossl_tpu.training import pretrain as jpt  # noqa: E402
from audiossl_tpu.transforms import augment as jau  # noqa: E402
from audiossl_tpu_torch.compat import checkpoint as ck  # noqa: E402
from audiossl_tpu_torch.methods.atst import method as tm  # noqa: E402
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402
from audiossl_tpu_torch.models import byol as tbyol  # noqa: E402
from audiossl_tpu_torch.ops import interpolate as tip  # noqa: E402
from audiossl_tpu_torch.training import pretrain as tpt  # noqa: E402
from audiossl_tpu_torch.transforms import augment as tau  # noqa: E402

B, L = 4, 20000
VALID = np.asarray([20000, 18000, 16000, 12000], np.int32)
OPT = dict(learning_rate=5e-4, warmup_steps=0, max_steps=1000, ema=0.99)
ZERO_GRAD = "encoder.norm.bias"


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ #
# augmentations
# ------------------------------------------------------------------ #
def test_sample_bicubic_2d_matches_jax():
    rng = np.random.RandomState(0)
    canvas = rng.randn(3, 12, 20).astype(np.float32)
    ys = rng.uniform(0, 11, (3, 9)).astype(np.float32)
    xs = rng.uniform(0, 19, (3, 15)).astype(np.float32)
    lo_y, hi_y = np.asarray([0, 2, 1]), np.asarray([11, 9, 6])
    lo_x, hi_x = np.asarray([0, 3, 5]), np.asarray([19, 15, 12])
    want = jip.sample_bicubic_2d(*map(jnp.asarray, (canvas, ys, xs, lo_y,
                                                    hi_y, lo_x, hi_x)))
    got = tip.sample_bicubic_2d(*map(_t, (canvas, ys, xs, lo_y, hi_y, lo_x,
                                          hi_x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("lens", [(0.6, 1.0), (1.0, 1.0)])
def test_sample_crop_lengths_matches_jax(lens):
    key = jax.random.PRNGKey(1)
    want = jau.sample_crop_lengths(key, 64, *lens)
    got = tau.sample_crop_lengths(_t(jax.random.uniform(key, (64,))), 64,
                                  *lens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rrc_draws(key, n):
    return tuple(_t(jax.random.uniform(k, (n,)))
                 for k in jax.random.split(key, 4))


def test_random_resize_crop_general_form_matches_jax():
    """The clip recipe's form: canvas (1, 1.5), freq and time scales
    (0.6, 1.5), ragged valid widths."""
    rng = np.random.RandomState(2)
    spec = rng.randn(6, 64, 30).astype(np.float32)
    frames = np.asarray([30, 20, 7, 30, 1, 29], np.int32)
    key = jax.random.PRNGKey(3)
    kw = dict(virtual_crop_scale=(1.0, 1.5), freq_scale=(0.6, 1.5),
              time_scale=(0.6, 1.5))
    want = jau.random_resize_crop(key, jnp.asarray(spec),
                                  valid_frames=jnp.asarray(frames), **kw)
    h, w, iy, ix = _rrc_draws(key, 6)
    got = tau.random_resize_crop(_t(spec), h, iy, w, ix,
                                 valid_frames=_t(frames).long(), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_port_resize_crop_draws_are_uniform():
    gen = torch.Generator().manual_seed(4)
    draws = tau.draw_resize_crop(gen, 1000, "cpu", time=True)
    assert len(draws) == 4
    for u in draws:
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.05


def test_clip_byol_loss_matches_jax():
    rng = np.random.RandomState(5)
    s = rng.randn(8, 32).astype(np.float32)
    t = rng.randn(8, 32).astype(np.float32)
    want = jbyol.clip_byol_loss(jnp.asarray(s), jnp.asarray(t))
    got = tbyol.clip_byol_loss(_t(s), _t(t))
    for a, b in zip(got, want):
        assert float(a) == pytest.approx(float(b), rel=1e-5)


# ------------------------------------------------------------------ #
# the clip encoder
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("fused", [False, True])
def test_clip_encoder_forward_matches_jax(fused):
    """``ast_tiny`` on the JAX weights through ``state_dict_from_flax``:
    the normed CLS embedding, with ragged lengths (one sample with no whole
    patch, so the CLS token is its only valid key)."""
    rng = np.random.RandomState(6)
    W = 101
    mel = rng.randn(3, 64, W).astype(np.float32)
    lengths = np.asarray([101, 57, 3], np.int32)
    enc = jatst.ast_tiny(spec_w=W, fused_attention=fused)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(mel),
                      length=jnp.asarray(lengths), deterministic=True)["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)
    want = np.asarray(enc.apply({"params": params}, jnp.asarray(mel),
                                jnp.asarray(lengths), deterministic=True))
    sd = ck.state_dict_from_flax(params)
    assert "cls_token" in sd and "norm.weight" in sd
    port = tatst.ast_tiny(spec_w=W, fused_attention=fused,
                          device="cpu").eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(_t(mel), _t(lengths).long()).numpy()
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


# ------------------------------------------------------------------ #
# one whole step
# ------------------------------------------------------------------ #
def _jax_method(lens):
    cfg = jm.ClipPretrainConfig(arch="tiny", anchor_len=lens,
                                positive_len=lens,
                                optimizer=jpt.OptimizerConfig(**OPT))
    m = jm.ClipMethod(cfg)
    m.student = m.student.clone(
        encoder=m.student.encoder.clone(drop_path_rate=0.0))
    m.teacher = m.teacher.clone(
        encoder=m.teacher.encoder.clone(drop_path_rate=0.0))
    return m


def _view_draws(k, lens, cfg, k_cm=None, k_aug=None):
    """One view's draws from its key (``_one_view``), or from its crop and
    augmentation keys; no crop draws without a crop key."""
    if k is not None:
        k_cm, k_aug = jax.random.split(k)
    crop_len = crop = None
    if k_cm is not None:
        k_len, k_crop = jax.random.split(k_cm)
        if lens[0] != lens[1]:
            crop_len = _t(jax.random.uniform(k_len, (B,)))
        crop = _t(jax.random.uniform(k_crop, (B,)))
    k_mix, k_rrc = jax.random.split(k_aug)
    k1, k2 = jax.random.split(k_mix)
    a = np.float32(cfg.mixup_ratio) * np.asarray(
        jax.random.uniform(k1, (B, 1, 1)))[:, 0, 0]
    shift = jax.random.randint(k2, (B,), 1, max(B, 2))
    h, w, iy, ix = _rrc_draws(k_rrc, B)
    return tm.ViewDraws(crop_len=crop_len, crop=crop,
                        mix=(_t(a), _t(shift).long()), rrc=(h, iy, w, ix))


def _views_draws(key, cfg):
    """The random numbers of jm.clip_train_views(key, ...)."""
    k1, k2 = jax.random.split(key)
    if cfg.different_positive:
        views = (_view_draws(k1, cfg.anchor_len, cfg),
                 _view_draws(k2, cfg.positive_len, cfg))
    else:
        k_cm, k_aug1 = jax.random.split(k1)
        views = (_view_draws(None, cfg.anchor_len, cfg, k_cm, k_aug1),
                 _view_draws(None, cfg.positive_len, cfg, k_aug=k2))
    return tm.ClipStepDraws(views=views, student_dp=None, teacher_dp=None)


@pytest.mark.parametrize("different_positive", [True, False])
def test_clip_train_views_match_jax(different_positive):
    kw = dict(anchor_len=(0.6, 1.0), positive_len=(0.6, 1.0),
              different_positive=different_positive)
    rng = np.random.RandomState(7)
    wav = (rng.randn(B, L) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want_mel, want_frames = jm.clip_train_views(
        key, jnp.asarray(wav), jnp.asarray(VALID), jm.ClipPretrainConfig(**kw))
    cfg = tm.ClipPretrainConfig(**kw)
    got_mel, got_frames = tm.clip_train_views(
        _t(wav), _t(VALID).long(), cfg, _views_draws(key, cfg))
    np.testing.assert_array_equal(got_frames.numpy(), np.asarray(want_frames))
    np.testing.assert_allclose(got_mel.numpy(), np.asarray(want_mel),
                               atol=1e-5)


def _jax_method(lens):
    cfg = jm.ClipPretrainConfig(arch="tiny", anchor_len=lens,
                                positive_len=lens,
                                optimizer=jpt.OptimizerConfig(**OPT))
    m = jm.ClipMethod(cfg)
    m.student = m.student.clone(
        encoder=m.student.encoder.clone(drop_path_rate=0.0))
    m.teacher = m.teacher.clone(
        encoder=m.teacher.encoder.clone(drop_path_rate=0.0))
    return m


@pytest.fixture(scope="module", params=[(1.0, 1.0), (0.6, 1.0)],
                ids=["fixed_crops", "crop_lengths_drawn"])
def one_step(request):
    lens = request.param
    rng = np.random.RandomState(0)
    wav = (rng.randn(B, L) * 0.1).astype(np.float32)
    for i, v in enumerate(VALID):
        wav[i, v:] = 0.0
    batch = {"wav": jnp.asarray(wav), "valid": jnp.asarray(VALID)}
    m = _jax_method(lens)
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

    pcfg = tm.ClipPretrainConfig(arch="tiny", anchor_len=lens,
                                 positive_len=lens, drop_path_rate=0.0,
                                 optimizer=tpt.OptimizerConfig(**OPT))
    method = tm.ClipMethod(pcfg, device="cpu")
    pstate = ck.pretrain_state_from_flax(state, method,
                                         torch.Generator().manual_seed(0))
    before = {k: v.detach().clone()
              for k, v in pstate.student.state_dict().items()}
    t_before = {k: v.detach().clone()
                for k, v in pstate.teacher.state_dict().items()}
    k_aug, _, _ = jax.random.split(step_rng, 3)
    out = method.make_step()(pstate, {"wav": _t(wav), "valid": _t(VALID)},
                             _views_draws(k_aug, pcfg))
    return dict(jax_loss=float(loss), jax_grads=grads, jax_new=new_state,
                jax_metrics=metrics, port=pstate, port_out=out,
                before=before, t_before=t_before)


def _grad(p):
    """A parameter's gradient; the step reads a missing one (mask_embed,
    which a clip encoder does not use) as zeros."""
    return (torch.zeros_like(p) if p.grad is None else p.grad).numpy()


def test_step_loss_matches_jax(one_step):
    got = float(one_step["port_out"]["loss"])
    want = one_step["jax_loss"]
    assert float(one_step["jax_metrics"]["loss"]) == pytest.approx(want,
                                                                   rel=1e-6)
    assert got == pytest.approx(want, rel=1e-5)
    for k in ("std_cls_s", "std_cls_t"):
        assert float(one_step["port_out"][k]) == pytest.approx(
            float(one_step["jax_metrics"][k]), rel=1e-5)


def test_step_gradients_match_jax(one_step):
    want = ck.branch_state_from_flax(ck._tree_np(one_step["jax_grads"]))
    params = dict(one_step["port"].student.named_parameters())
    assert set(want) == set(params)
    gmax = max(float(v.norm()) for v in want.values())
    bad = []
    for k, p in params.items():
        g = _grad(p)
        if k == ZERO_GRAD:
            assert max(np.linalg.norm(g), float(want[k].norm())) < 1e-6 * gmax
        elif not want[k].any():
            assert not g.any(), k  # mask_embed, pos_embed past the crop
        elif _rel(g, want[k].numpy()) >= 1e-4:
            bad.append((k, _rel(g, want[k].numpy())))
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
        if k == ZERO_GRAD:
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
            if k == ZERO_GRAD:
                # the student's step there is Adam's first step of rounding
                # noise, anywhere within one step: through the EMA it moves
                # the teacher by at most (1 - m) of a step
                assert np.abs(v.numpy() - want[k].numpy()).max() <= (
                    lr * (1.0 - ema))
                continue
            err = _rel(v.numpy(), want[k].numpy())
            if err >= 1e-6:
                bad.append((k, err))
            continue
        d_got = (v - before[k]).numpy()
        d_want = want[k].numpy() - before[k].numpy()
        # Adam's first step maps g to about g / (|g| + eps): below 10 eps it
        # divides g's rounding by eps (a gradient of 1e-6 that the two
        # frameworks round 5e-7 apart moves its update by a third of a
        # step), so those elements are held to one step, the others to a
        # tenth of a step each and to rel L2 1e-3 together
        big = np.abs(grads[k].numpy()) >= 10 * tpt.OptimizerConfig().eps
        err = np.abs(d_got - d_want)
        assert err.max() <= lr and (err[big].max(initial=0.0)
                                    <= 0.1 * lr), k
        if k != ZERO_GRAD and big.any() and _rel(d_got[big], d_want[big]) >= 1e-3:
            bad.append((k, _rel(d_got[big], d_want[big])))
    assert not bad, bad


def test_pretrain_state_bridge_covers_the_clip_branch():
    """Every parameter and BatchNorm statistic of the JAX clip branches has
    its place in the port's branches, under the reference AST's names."""
    m = _jax_method((1.0, 1.0))
    state = m.init_state(jax.random.PRNGKey(0))
    sd = ck.branch_state_from_flax(ck._tree_np(state.params),
                                   ck._tree_np(state.batch_stats))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        (state.params, state.batch_stats)))
    assert sum(v.numel() for v in sd.values()) == n_jax
    method = tm.ClipMethod(tm.ClipPretrainConfig(arch="tiny",
                                                 anchor_len=(1.0, 1.0),
                                                 positive_len=(1.0, 1.0)),
                           device="cpu")
    assert set(method.student.state_dict()) == set(sd)
    assert {"encoder.cls_token", "encoder.norm.weight"} <= set(sd)


def test_three_clip_steps_on_a_repeated_batch_lower_the_loss():
    """The port's own draws, drop-path on: the loss falls and the teacher
    moves."""
    cfg = tm.ClipPretrainConfig(
        arch="tiny", anchor_len=(0.6, 1.0), positive_len=(0.6, 1.0),
        optimizer=tpt.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                      max_steps=100))
    method = tm.ClipMethod(cfg, device="cpu", seed=3)
    state = method.init_state(seed=4)
    wav = torch.from_numpy(
        (np.random.RandomState(5).randn(B, L) * 0.1).astype(np.float32))
    batch = {"wav": wav, "valid": torch.from_numpy(VALID)}
    draws = method.draw(torch.Generator().manual_seed(6), B)
    assert draws.student_dp is not None and draws.teacher_dp is not None
    assert draws.views[0].crop_len is not None
    step = method.make_step()
    t0 = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    losses = [float(step(state, batch, draws)["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    assert losses[0] > losses[1] > losses[2], losses
    moved = [k for k, v in state.teacher.state_dict().items()
             if not torch.equal(v, t0[k])]
    assert "encoder.blocks.1.attn.qkv.weight" in moved
