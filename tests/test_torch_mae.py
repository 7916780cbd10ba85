"""The port's MAE method against the JAX package's on the CPU.

Tiny config: 0.5 s anchors (51 frames, 12 patches of 16 x 16, 9 masked),
encoder width 32, 2 blocks, 2 heads, decoder 32 wide, 1 block, 2 heads.
The JAX params (norms and biases moved off their init values) are carried
into the port by ``compat.checkpoint.mae_state_from_flax``, and JAX's
mask noise (and in the step its crop uniforms) is rebuilt from its keys
and handed to the port. Tolerances: the CLS output atol 1e-5 and the loss
rel 1e-5; each leaf's gradient rel L2 1e-4; after one step the
parameters and both Adam moments rtol 1e-5, atol 2e-5.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import traverse_util  # noqa: E402

from audiossl_tpu.methods.mae import method as jm  # noqa: E402
from audiossl_tpu.training import pretrain as jpt  # noqa: E402
from audiossl_tpu_torch.compat import checkpoint as ck  # noqa: E402
from audiossl_tpu_torch.methods.mae import method as tm  # noqa: E402
from audiossl_tpu_torch.training import pretrain as tpt  # noqa: E402

KW = dict(anchor_len=0.5, embed_dim=32, depth=2, num_heads=2,
          dec_embed_dim=32, dec_depth=1, dec_num_heads=2)
OPT = dict(learning_rate=5e-4, warmup_steps=0, max_steps=1000)
B, L = 4, 12000
VALID = np.asarray([12000, 10000, 8000, 6000], np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nudged(params, seed=1):
    """``params`` with every bias and LayerNorm scale moved off its init
    value, so their gradients and updates are exercised."""
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 1000))

    def nudge(path, p):
        if path[-1] in ("bias", "scale"):
            return p + 0.05 * jax.random.normal(next(keys), p.shape)
        return p

    return traverse_util.unflatten_dict(
        {k: nudge(k, v) for k, v in
         traverse_util.flatten_dict(params).items()})


@pytest.fixture(scope="module")
def jax_method():
    cfg = jm.MAEConfig(optimizer=jpt.OptimizerConfig(**OPT), **KW)
    m = jm.MAEMethod(cfg)
    state = jax.jit(m.init_state)(jax.random.PRNGKey(0))
    return m, state._replace(params=_nudged(state.params))


def _port(device="cpu"):
    cfg = tm.MAEConfig(optimizer=tpt.OptimizerConfig(**OPT), **KW)
    return tm.MAEMethod(cfg, device=device, seed=5)


def test_config_counts_match_jax():
    want = jm.MAEConfig(**KW)
    got = tm.MAEConfig(**KW)
    assert (got.out_samples, got.out_frames, got.n_patches, got.n_masked) \
        == (want.out_samples, want.out_frames, want.n_patches,
            want.n_masked) == (8000, 51, 12, 9)
    full = tm.MAEConfig()
    assert (full.n_patches, full.n_masked) == (148, 111)


def test_bridge_places_every_leaf(jax_method):
    _, state = jax_method
    sd = ck.mae_state_from_flax(ck._tree_np(state.params))
    model = _port().model
    assert set(sd) == set(model.state_dict())
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(state.params))
    assert sum(v.numel() for v in sd.values()) == n_jax
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    with pytest.raises(KeyError, match="no place"):
        ck.mae_state_from_flax({**ck._tree_np(state.params),
                                "prompt_embed": np.zeros((1, 2, 32))})


def _forward_both(m, params, mel, key):
    """JAX's (cls, loss, grads) and the port's (cls, loss, model) on the
    same mel and JAX's noise from ``key``."""
    def loss_fn(p):
        cls, loss = m.model.apply({"params": p}, jnp.asarray(mel), key,
                                  deterministic=False)
        return loss, cls

    (loss, cls), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    model = _port().model
    model.load_state_dict(ck.mae_state_from_flax(ck._tree_np(params)))
    noise = torch.from_numpy(np.array(jax.random.uniform(
        key, (mel.shape[0], m.cfg.n_patches))))
    got_cls, got_loss = model(torch.from_numpy(mel), noise)
    got_loss.backward()
    got_cls, got_loss = got_cls.detach(), got_loss.detach()
    return (np.asarray(cls), float(loss), grads), (got_cls, got_loss, model)


def test_model_output_loss_and_gradients_match_jax(jax_method):
    m, state = jax_method
    mel = np.random.RandomState(3).randn(B, 64, 51).astype(np.float32)
    (cls, loss, grads), (got_cls, got_loss, model) = _forward_both(
        m, state.params, mel, jax.random.PRNGKey(7))
    np.testing.assert_allclose(got_cls.numpy(), cls, atol=1e-5)
    assert float(got_loss) == pytest.approx(loss, rel=1e-5)
    want = ck.mae_state_from_flax(ck._tree_np(grads))
    params = dict(model.named_parameters())
    assert set(params) == set(want)
    bad = [(k, err) for k, p in params.items()
           if (err := _rel(p.grad.numpy(), want[k].numpy())) > 1e-4]
    assert not bad, bad


def test_tied_noise_keeps_jax_stable_order(jax_method, monkeypatch):
    """A noise whose values tie (9 of 12 equal per row) picks the kept and
    masked patches in JAX's stable argsort order: the port's CLS output
    and loss equal JAX's on the same tied noise, and differ from the
    port's on the reverse tie order."""
    m, state = jax_method
    mel = np.random.RandomState(4).randn(B, 64, 51).astype(np.float32)
    noise = np.full((B, 12), 0.5, np.float32)
    noise[:, [1, 5, 10]] = [0.9, 0.1, 0.3]
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(noise))
    cls, loss = jax.jit(lambda p, x: m.model.apply(
        {"params": p}, x, jax.random.PRNGKey(0), deterministic=True))(
        state.params, jnp.asarray(mel))
    monkeypatch.undo()
    model = _port().model
    model.load_state_dict(ck.mae_state_from_flax(ck._tree_np(state.params)))
    with torch.no_grad():
        got_cls, got_loss = model(torch.from_numpy(mel),
                                  torch.from_numpy(noise))
        # the same ties broken the other way: another kept set
        _, rev_loss = model(torch.from_numpy(mel), torch.from_numpy(
            noise - np.arange(12, dtype=np.float32) * 1e-6))
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(cls), atol=1e-5)
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
    assert abs(float(rev_loss) - float(loss)) > 1e-3 * float(loss)


def test_step_matches_jax(jax_method):
    """One ``MAEMethod`` step from JAX's state with JAX's crop and noise
    draws against JAX's ``step_fn``: the loss, the parameters and both
    moments, Adam's count and the step."""
    m, state = jax_method
    rng = np.random.RandomState(0)
    wav = (rng.randn(B, L) * 0.1).astype(np.float32)
    for i, v in enumerate(VALID):
        wav[i, v:] = 0.0
    new, metrics = jax.jit(m.make_step())(
        state, {"wav": jnp.asarray(wav), "valid": jnp.asarray(VALID)})
    _, k_crop, k_mask, _ = jax.random.split(state.rng, 4)
    draws = tm.MAEDraws(
        crop=torch.from_numpy(np.array(jax.random.uniform(k_crop, (B,)))),
        noise=torch.from_numpy(np.array(jax.random.uniform(
            k_mask, (B, m.cfg.n_patches)))))
    method = _port()
    pstate = ck.model_state_from_flax(state, method,
                                      torch.Generator().manual_seed(0))
    assert pstate.teacher is None
    assert all(t is None for t in pstate.teacher_leaves)
    out = method.make_step()(pstate, {"wav": torch.from_numpy(wav),
                                      "valid": torch.from_numpy(VALID)},
                             draws)
    assert float(out["loss"]) == pytest.approx(float(metrics["loss"]),
                                               rel=1e-5)
    assert set(out) == {"loss", "lr", "wd"}
    for k in ("lr", "wd"):
        assert out[k] == pytest.approx(float(metrics[k]), rel=1e-6)
    assert pstate.step == int(new.step) == 1
    assert pstate.count == int(new.opt_state.count) == 1
    want = {"params": ck.mae_state_from_flax(ck._tree_np(new.params)),
            "mu": ck.mae_state_from_flax(ck._tree_np(new.opt_state.mu)),
            "nu": ck.mae_state_from_flax(ck._tree_np(new.opt_state.nu))}
    got = {"params": dict(pstate.student.named_parameters()),
           "mu": pstate.mu, "nu": pstate.nu}
    for group, w in want.items():
        for k, v in w.items():
            np.testing.assert_allclose(got[group][k].detach().numpy(),
                                       v.numpy(), rtol=1e-5, atol=2e-5,
                                       err_msg=f"{group} {k}")
