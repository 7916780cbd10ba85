"""Two SED steps against the JAX package's jitted step (CPU).

``frame_ast_tiny`` (2 blocks, drop-path rate 0.4, so block 1 drops rows)
on 1 s clips, a batch of 4 strong and 4 weak rows of ragged lengths, from
one state carried across by ``compat.checkpoint.sed_state_from_flax``,
JAX's drop-path uniforms handed to the port (JAX's ``drop_path`` is
patched to draw from known keys): the DCASE step (SGD with momentum, the
cosine learning rate), the AudioSet-strong layer decay (``lr_scale``
0.75: the factors multiply the traced update) and freeze mode (the head
alone moves). Losses rtol 1e-5; every parameter and the momentum trace
rtol 1e-5, atol 2e-5, as ``test_torch_finetune.py`` holds its steps.
Distill mode, in both combine modes, is held by the loss of one step
against JAX's in freeze mode, with a fixed teacher.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models import transformer as jtr  # noqa: E402
from audiossl_tpu.sed import module as jmodule  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import sed_state_from_flax  # noqa: E402
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402
from audiossl_tpu_torch.sed import module  # noqa: E402

B, C, T, W = 8, 3, 25, 101  # clips, labels, frames, mel frames (1 s)
DP_RATE = 0.4
COMMON = dict(num_labels=C, learning_rate=0.1, max_epochs=2,
              steps_per_epoch=1, warmup_epochs=0)
CASES = {"dcase": {}, "lr_scale": dict(lr_scale=0.75),
         "freeze": dict(freeze_mode=True)}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _batch(rng):
    wav = (rng.randn(B, 16000) * 0.1).astype(np.float32)
    valid = np.asarray([16000, 12000, 16000, 8000] * 2, np.int32)
    for i, v in enumerate(valid):
        wav[i, v:] = 0.0
    return {"wav": wav, "valid": valid,
            "strong": (rng.rand(B, T, C) > 0.7).astype(np.float32),
            "source": np.asarray([0] * 4 + [1] * 4, np.int32)}


def _start(rng, cfg_kw, teacher=None):
    """JAX's task and state from jittered tiny params, and the port's task
    and state loaded from them."""
    jenc = jatst.frame_ast_tiny(spec_w=W, drop_path_rate=DP_RATE)
    params = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, W)),
                       deterministic=True)["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)
    # JAX sizes its head's init input by audio_len; the port's head needs
    # no length
    jcfg = jmodule.SEDConfig(**COMMON, **cfg_kw, audio_len=1.0)
    jtask = jmodule.SEDTask(jenc, jcfg,
                            teacher_fn=None if teacher is None
                            else teacher[0])
    jstate = jtask.init_state(jax.random.PRNGKey(1), params)
    task = module.SEDTask(
        tatst.frame_ast_tiny(spec_w=W, device="cpu"),
        module.SEDConfig(**COMMON, **cfg_kw, drop_path_rate=DP_RATE),
        teacher_fn=None if teacher is None else teacher[1])
    enc_sd, head_sd = sed_state_from_flax(jstate.enc_params,
                                          jstate.head_params)
    task.encoder.load_state_dict(enc_sd)
    task.head.load_state_dict(head_sd)
    return jtask, jstate, task, task.init_state()


def _flat(state):
    """JAX's params and momentum trace by the port's names."""
    out = []
    for enc, hd in ((state.enc_params, state.head_params),
                    (state.opt_state.trace["enc"],
                     state.opt_state.trace["head"])):
        e, h = sed_state_from_flax(enc, hd)
        d = {f"encoder.{k}": v for k, v in e.items()}
        d.update((f"head.{k}", v) for k, v in h.items())
        out.append(d)
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def two_steps(request):
    rng = np.random.RandomState(3)
    batches = [_batch(rng) for _ in range(2)]
    jtask, jstate, task, state = _start(rng, CASES[request.param])
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
        step = jax.jit(jtask.make_train_step())
        jax_states, jax_metrics = [jstate], []
        for b in batches:
            s, m = step(jax_states[-1], {k: jnp.asarray(v)
                                         for k, v in b.items()})
            jax_states.append(s)
            jax_metrics.append(m)
    finally:
        mp.undo()
    # one trace: block 0 has rate 0 and draws nothing; block 1 draws for
    # its attention, then its MLP branch; both steps run that trace
    freeze = request.param == "freeze"
    assert len(calls) == (0 if freeze else 2)
    u = None
    if not freeze:
        u = torch.zeros(2, 2, B)
        for j, (rate, k, shape) in enumerate(calls):
            assert rate == pytest.approx(DP_RATE)
            u[1, j] = torch.from_numpy(np.array(
                jax.random.uniform(k, shape))).reshape(-1)
        assert float((u[1] < DP_RATE).sum()) > 0  # some rows dropped
    before = {k: p.detach().clone() for k, p in task.encoder.named_parameters()}
    metrics = [task.train_step(state, b, u)[1] for b in batches]
    return dict(case=request.param, jax_states=jax_states,
                jax_metrics=jax_metrics, state=state, metrics=metrics,
                before=before)


def test_sed_step_losses_match_jax(two_steps):
    for m, jm in zip(two_steps["metrics"], two_steps["jax_metrics"]):
        for k in ("loss", "strong_loss", "weak_loss"):
            assert _rel(m[k], jm[k]) <= 1e-5, (k, m[k], jm[k])
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=2.5e-7)
    assert two_steps["state"].step == 2


def test_sed_step_parameters_match_jax(two_steps):
    want, want_mu = _flat(two_steps["jax_states"][-1])
    state = two_steps["state"]
    got = {f"encoder.{k}": v for k, v in state.encoder.state_dict().items()}
    got.update((f"head.{k}", v) for k, v in state.head.state_dict().items())
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=k)
    moved = [k for k, p in state.encoder.named_parameters()
             if not torch.equal(p, two_steps["before"][k])]
    if two_steps["case"] == "freeze":
        assert not moved and set(state.mu) == {
            "head.linear.weight", "head.linear.bias",
            "head.linear_softmax.weight", "head.linear_softmax.bias"}
    else:
        assert len(moved) > 10
    for k, v in state.mu.items():
        np.testing.assert_allclose(v.numpy(), want_mu[k].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("combine", ["add", "average_strong"])
def test_distill_loss_matches_jax(combine):
    rng = np.random.RandomState(4)
    batch = _batch(rng)
    t_strong = rng.rand(B, C, T + 2).astype(np.float32)
    t_weak = rng.rand(B, C).astype(np.float32)
    teachers = (lambda wav, valid: (jnp.asarray(t_strong),
                                    jnp.asarray(t_weak)),
                lambda wav, valid: (torch.from_numpy(t_strong),
                                    torch.from_numpy(t_weak)))
    kw = dict(freeze_mode=True, distill_weight=0.5, distill_combine=combine)
    jtask, jstate, task, state = _start(rng, kw, teachers)
    _, jm = jax.jit(jtask.make_train_step())(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    m = task.train_step(state, batch)[1]
    for k in ("loss", "strong_loss", "weak_loss"):
        assert _rel(m[k], jm[k]) <= 1e-5, (k, m[k], jm[k])
    plain = float(m["strong_loss"]) + float(m["weak_loss"])
    assert abs(float(m["loss"]) - plain) > 1e-3  # the teacher's term counts
