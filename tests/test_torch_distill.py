"""Clip-to-frame distillation (``methods/distill/method.py``) against the
JAX package's ``DistillMethod`` (CPU).

* ``linear_head_state_from_torch`` against JAX's ``linear_head_from_torch``
  on a reference head's state dict (tolerance 0), with and without an
  affine norm, and the loaded head's logits against JAX's head (rtol
  1e-5, atol 1e-6: f32 sums in another order);
* the teacher's logits against ``DistillMethod._teacher_logits``:
  clip-tiny, 151 frames, chunks of 61, ragged lengths (one shorter than a
  chunk), the teacher head on non-trivial running statistics; rtol 1e-5,
  atol 1e-6 (logits near zero);
* the student's scene embedding against ``_student_scene``: frame-tiny,
  ``student_chunk_len`` 61 (3 chunks), one clip whose last chunk is
  unmarked; rtol 1e-5, atol 1e-6;
* two whole steps from one state carried across by
  ``compat.checkpoint.distill_state_from_flax`` against JAX's jitted
  ``make_step`` with JAX's draws (its crop uniforms, and its drop-path
  uniforms captured by patching ``models.transformer.drop_path`` to draw
  from known keys; the student's rate 0.4, so rows drop): multi-label with
  a random crop of clips longer than it and a clip that does not engage,
  single-label with a central crop and a chunked student (the default
  clip, 3), and a ``grad_clip`` small enough to engage;
  ``lambda_d`` 0.5. Losses rel 1e-5; every parameter, the head's
  statistics and the momentum trace rtol 1e-5, atol 2e-5, as
  ``test_torch_finetune.py`` holds its steps;
* the student's evaluation logits against ``make_eval_fn`` from the
  carried state, rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.compat.torch_import import linear_head_from_torch  # noqa: E402
from audiossl_tpu.methods.distill import method as jdm  # noqa: E402
from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models import transformer as jtr  # noqa: E402
from audiossl_tpu.models.heads import LinearHead as JHead  # noqa: E402
from audiossl_tpu_torch.compat import checkpoint as ck  # noqa: E402
from audiossl_tpu_torch.methods.distill import method as tdm  # noqa: E402
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402
from audiossl_tpu_torch.models.heads import LinearHead  # noqa: E402

B, C, W, D = 4, 5, 101, 64  # clips, labels, encoders' frames, width
DP_RATE = 0.4
COMMON = dict(arch="tiny", num_labels=C, lambda_d=0.5, learning_rate=0.1,
              max_epochs=2, steps_per_epoch=1, warmup_epochs=0,
              chunk_len=61, pretrain_frames=W, layer_wise_lr=0.75)
CASES = {
    "multi_random": dict(L=24000, valid=[24000, 20000, 12000, 9000],
                         cfg=dict(multi_label=True, crop="random",
                                  max_len=1.0, grad_clip=100.0)),
    "single_central": dict(L=24000, valid=[24000, 20000, 9000, 3000],
                           cfg=dict(multi_label=False, crop="central",
                                    max_len=1.5, student_chunk_len=61)),
    "clipped": dict(L=24000, valid=[24000, 16000, 20000, 5000],
                    cfg=dict(multi_label=True, crop="random", max_len=1.0,
                             grad_clip=0.05)),
}


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _jitter(rng, tree, scale=0.05):
    return jax.tree.map(lambda a: np.asarray(a) + (scale * rng.randn(
        *np.shape(a))).astype(np.float32), tree)


def _methods(rng, cfg_kw):
    """JAX's method (its constructor, then the tiny encoders, the student's
    drop-path rate ``DP_RATE``) with jittered teacher params and head
    statistics, its state from jittered student and head params, and the
    port's method and state carried across from them."""
    jcfg = jdm.DistillConfig(**COMMON, **cfg_kw)
    jm = jdm.DistillMethod(jcfg, None, None)
    jm.teacher = jatst.ast_tiny(spec_w=W)
    jm.student = jatst.frame_ast_tiny(spec_w=W, drop_path_rate=DP_RATE)
    mel0 = jnp.zeros((1, 64, W))
    jm.teacher_params = _jitter(rng, jm.teacher.init(
        jax.random.PRNGKey(0), mel0, deterministic=True)["params"])
    hv = jm.t_head.init(jax.random.PRNGKey(1), jnp.zeros((2, 2 * D)),
                        train=False)
    jm.teacher_head_params = _jitter(rng, hv["params"], 0.5)
    jm.teacher_head_stats = {"norm": {
        "mean": (0.3 * rng.randn(2 * D)).astype(np.float32),
        "var": (0.5 + rng.rand(2 * D)).astype(np.float32)}}
    sp = _jitter(rng, jm.student.init(jax.random.PRNGKey(2), mel0,
                                      deterministic=True)["params"])
    js = jm.init_state(jax.random.PRNGKey(3), sp)
    js = js._replace(head_params=_jitter(rng, js.head_params, 0.2),
                     head_stats={"norm": {
                         "mean": (0.1 * rng.randn(D)).astype(np.float32),
                         "var": (0.5 + rng.rand(D)).astype(np.float32)}})

    teacher = tatst.ast_tiny(spec_w=W, device="cpu")
    teacher.load_state_dict(ck.state_dict_from_flax(jm.teacher_params))
    t_head = LinearHead(2 * D, C)
    sd = {}
    ck._head_from_flax(jm.teacher_head_params, jm.teacher_head_stats, "head",
                       sd)
    t_head.load_state_dict({k[len("head."):]: v for k, v in sd.items()})
    pm = tdm.DistillMethod(
        tdm.DistillConfig(**COMMON, **cfg_kw, drop_path_rate=DP_RATE),
        teacher, t_head, tatst.frame_ast_tiny(spec_w=W, device="cpu"))
    ps = ck.distill_state_from_flax(js, pm, torch.Generator().manual_seed(0))
    return jm, js, pm, ps


def _batch(rng, case):
    wav = (rng.randn(B, case["L"]) * 0.1).astype(np.float32)
    valid = np.asarray(case["valid"], np.int32)
    for i, v in enumerate(valid):
        wav[i, v:] = 0.0
    if case["cfg"]["multi_label"]:
        label = (rng.rand(B, C) > 0.5).astype(np.float32)
    else:
        label = rng.randint(C, size=B).astype(np.int32)
    return {"wav": wav, "valid": valid, "label": label}


# ------------------------------------------------------------------ #
# the teacher's head reader, the teacher, the student's scene
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("affine", [False, True])
def test_linear_head_reader_matches_jax(affine):
    g = torch.Generator().manual_seed(5)
    sd = {"linear.weight": torch.randn(7, 12, generator=g),
          "linear.bias": torch.randn(7, generator=g),
          "norm.running_mean": torch.randn(12, generator=g),
          "norm.running_var": torch.rand(12, generator=g) + 0.5,
          "norm.num_batches_tracked": torch.tensor(40)}
    if affine:
        sd["norm.weight"] = torch.rand(12, generator=g) + 0.5
        sd["norm.bias"] = torch.randn(12, generator=g)
    params, stats = linear_head_from_torch(sd)
    got = ck.linear_head_state_from_torch(sd)
    assert set(got) == {"linear.weight", "linear.bias", "norm.running_mean",
                        "norm.running_var"}
    np.testing.assert_array_equal(got["linear.weight"].numpy(),
                                  params["linear"]["kernel"].T)
    np.testing.assert_array_equal(got["linear.bias"].numpy(),
                                  params["linear"]["bias"])
    np.testing.assert_array_equal(got["norm.running_mean"].numpy(),
                                  stats["norm"]["mean"])
    np.testing.assert_array_equal(got["norm.running_var"].numpy(),
                                  stats["norm"]["var"])
    assert ("norm" in params) == affine  # carried by JAX, read by neither
    head = LinearHead(12, 7)
    head.load_state_dict(got)
    x = np.random.RandomState(6).randn(3, 12).astype(np.float32)
    want = JHead(num_labels=7).apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), train=False)
    np.testing.assert_allclose(head.eval()(_t(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def units():
    rng = np.random.RandomState(7)
    jm, js, pm, ps = _methods(rng, CASES["single_central"]["cfg"])
    mel = (rng.randn(B, 64, 151) * 2 - 3).astype(np.float32)
    return jm, js, pm, ps, mel


def test_teacher_logits_match_jax(units):
    jm, _, pm, _, mel = units
    frames = np.asarray([151, 120, 70, 40], np.int32)  # 40 < one chunk
    want = jm._teacher_logits(jnp.asarray(mel), jnp.asarray(frames))
    got = pm.teacher_logits(_t(mel), _t(frames).long())
    assert got.shape == (B, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


def test_student_scene_matches_jax(units):
    jm, js, pm, _, mel = units
    # chunks of 61: 126 frames leave 4 in the third chunk, which is not
    # marked; 61 fill the first exactly
    frames = np.asarray([151, 126, 61, 20], np.int32)
    want = jm._student_scene(js.student_params, jnp.asarray(mel),
                             jnp.asarray(frames))
    with torch.no_grad():
        got = pm.student_scene(_t(mel), _t(frames).long())
    assert got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert pm.chunk_len(151) == 61


# ------------------------------------------------------------------ #
# two whole steps, and evaluation
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module", params=sorted(CASES))
def two_steps(request):
    case = CASES[request.param]
    rng = np.random.RandomState(12)
    batches = [_batch(rng, case) for _ in range(2)]
    jm, js, pm, ps = _methods(rng, case["cfg"])
    jeval = jax.jit(jm.make_eval_fn())(
        js, {k: jnp.asarray(v) for k, v in batches[0].items()})
    peval = pm.eval_logits(ps, batches[0])
    keys = iter(np.asarray(jax.random.split(jax.random.PRNGKey(9), 64)))
    calls = []
    jax_drop_path = jtr.drop_path

    def drop_path(x, rate, deterministic, key):
        k = next(keys)
        calls.append((rate, k, (x.shape[0],) + (1,) * (x.ndim - 1)))
        return jax_drop_path(x, rate, deterministic, k)

    mp = pytest.MonkeyPatch()
    mp.setattr(jtr, "drop_path", drop_path)
    try:
        step = jax.jit(jm.make_step())
        jax_states, jax_metrics = [js], []
        for b in batches:
            s, m = step(jax_states[-1], {k: jnp.asarray(v)
                                         for k, v in b.items()})
            jax_states.append(s)
            jax_metrics.append(m)
    finally:
        mp.undo()
    # one trace: the student's block 0 has rate 0 and draws nothing; block
    # 1 draws for its attention, then its MLP branch, over every chunk
    # sequence; both steps run that trace
    assert len(calls) == 2
    rows = calls[0][2][0]
    u = torch.zeros(2, 2, rows)
    for j, (rate, k, shape) in enumerate(calls):
        assert rate == pytest.approx(DP_RATE)
        u[1, j] = _t(jax.random.uniform(k, shape)).reshape(-1)
    assert float((u[1] < DP_RATE).sum()) > 0  # some rows dropped
    before = {k: p.detach().clone() for k, p in ps.params.items()}
    metrics = []
    for s, b in zip(jax_states, batches):
        crop = None
        if case["cfg"]["crop"] == "random":
            _, k_crop, _ = jax.random.split(s.rng, 3)
            crop = _t(jax.random.uniform(k_crop, (B,)))
        metrics.append(pm.train_step(ps, b, tdm.DistillDraws(crop, u))[1])
    return dict(case=request.param, rows=rows, jax_states=jax_states,
                jax_metrics=jax_metrics, port=ps, metrics=metrics,
                before=before, jeval=jeval, peval=peval)


def test_distill_step_losses_match_jax(two_steps):
    for m, jm in zip(two_steps["metrics"], two_steps["jax_metrics"]):
        for k in ("loss", "loss_d", "loss_c"):
            assert _rel(m[k], jm[k]) <= 1e-5, (k, m[k], jm[k])
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=2.5e-7)
        # both terms count, and the teacher's targets are not the labels
        assert abs(float(m["loss_d"]) - float(m["loss_c"])) > 1e-3
    assert two_steps["port"].step == 2
    gnorms = [float(m["gnorm"]) for m in two_steps["metrics"]]
    clip = CASES[two_steps["case"]]["cfg"].get("grad_clip")
    if two_steps["case"] == "clipped":
        assert min(gnorms) > clip  # the clip engages on both steps
    elif two_steps["case"] == "multi_random":
        assert max(gnorms) < clip  # the unclipped update
    # the student ran 3 chunks a clip in the central case, one otherwise
    assert two_steps["rows"] == B * (3 if two_steps["case"] ==
                                     "single_central" else 1)


def _flat(state):
    """JAX's student, head and statistics, and its momentum trace, by the
    port's names."""
    params = {f"encoder.{k}": v for k, v in ck.state_dict_from_flax(
        jax.tree.map(np.asarray, state.student_params)).items()}
    ck._head_from_flax(jax.tree.map(np.asarray, state.head_params),
                       jax.tree.map(np.asarray, state.head_stats), "head",
                       params)
    trace = state.opt_state.trace
    mu = {f"encoder.{k}": v for k, v in ck.state_dict_from_flax(
        jax.tree.map(np.asarray, trace["enc"])).items()}
    ck._head_from_flax(jax.tree.map(np.asarray, trace["head"]), {}, "head",
                       mu)
    return params, mu


def test_distill_step_parameters_match_jax(two_steps):
    want, want_mu = _flat(two_steps["jax_states"][-1])
    port = two_steps["port"]
    got = {f"encoder.{k}": v for k, v in port.encoder.state_dict().items()}
    got.update((f"head.{k}", v) for k, v in port.head.state_dict().items())
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=k)
    moved = [k for k, v in port.params.items()
             if not torch.equal(v, two_steps["before"][k])]
    assert len(moved) > 10
    # the embeddings train (freeze_embed off: factor 0.75 ** depth)
    assert "encoder.pos_embed" in moved
    assert set(port.mu) == set(want_mu)
    for k, v in port.mu.items():
        np.testing.assert_allclose(v.numpy(), want_mu[k].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=k)


def test_distill_eval_matches_jax(two_steps):
    got, want = two_steps["peval"], np.asarray(two_steps["jeval"])
    assert got.shape == (B, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
