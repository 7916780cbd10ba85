"""The data2vec variant of ATST-Frame (``avg_blocks``, the linear and empty
projectors) and interpolated positions, the port against the JAX package
on the CPU.

* The frame encoder's ``avg_blocks`` output (the last blocks' outputs
  instance-normalized over the tokens and averaged) against JAX's on the
  module route in f32 (rel L2 1e-5: f32 sums in another order) and on the
  bf16 block-kernel route against JAX's TPU composition run on the CPU
  (bf16 ``prepare_tokens``, ``encoder_blocks_infer(interpret=True)`` with
  ``collect_from``, JAX's instance norm and mean): rel L2 1e-2 (the same
  rounding points; an f32 sum in another order moves an element by one
  bf16 step, which the normalization carries on).
* ``projector_linear`` against flax's ``Dense`` in f32 (rel 1e-6) and
  bf16 (rel L2 4e-3, bf16 outputs).
* One whole frame-tiny step of each variant against JAX's step from the
  same bridged state with JAX's draws handed in, at
  ``test_torch_pretrain.py``'s tolerances: loss rel 1e-5; gradients (JAX's
  read from its first Adam moment, (1 - b1) g), Adam's moments rel L2
  1e-4; updates p' - p rel L2 1e-3 where the gradient is above 10 eps,
  everywhere within a tenth of lr; teacher values 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import traverse_util  # noqa: E402

import test_torch_pretrain as tp  # noqa: E402
from audiossl_tpu.methods.atstframe import method as jm  # noqa: E402
from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models import byol as jbyol  # noqa: E402
from audiossl_tpu.ops import pallas_block as jpb  # noqa: E402
from audiossl_tpu.training import pretrain as jpt  # noqa: E402
from audiossl_tpu_torch.compat import checkpoint as ck  # noqa: E402
from audiossl_tpu_torch.methods.atstframe import method as tm  # noqa: E402
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402
from audiossl_tpu_torch.models.byol import Projector  # noqa: E402
from audiossl_tpu_torch.training import pretrain as tpt  # noqa: E402

T = 101  # 1 s of frames: 25 tokens
LENGTHS = np.asarray([101, 80, 41, 17], np.int32)


def _rel(a, b):
    return tp._rel(a, b)


def _encoder_params(enc, rng):
    x = jnp.zeros((2, 64, T), jnp.float32)
    params = jax.jit(enc.init, static_argnames="deterministic")(
        {"params": jax.random.PRNGKey(0)}, x, jnp.full((2,), T, jnp.int32),
        deterministic=True)
    flat = traverse_util.flatten_dict(params["params"])
    # norms and biases off their init values
    flat = {k: v + (0.1 * rng.randn(*v.shape).astype(np.float32)
                    if k[-1] in ("bias", "scale") else 0.0)
            for k, v in flat.items()}
    return traverse_util.unflatten_dict(flat)


def _port_encoder(params, **kw):
    enc = tatst.frame_ast_tiny(spec_w=T, device="cpu", **kw)
    enc.load_state_dict(ck.state_dict_from_flax(params))
    return enc.train()


def test_avg_blocks_encoder_matches_jax_module_route():
    rng = np.random.RandomState(0)
    jenc = jatst.frame_ast_tiny(spec_w=T, avg_blocks=2, drop_path_rate=0.0)
    params = _encoder_params(jenc, rng)
    mel = rng.randn(4, 64, T).astype(np.float32)
    mask = rng.rand(4, 25) < 0.5
    want, want_sel = jax.jit(jenc.apply, static_argnames=(
        "apply_mask", "deterministic"))(
        {"params": params}, jnp.asarray(mel), jnp.asarray(LENGTHS),
        jnp.asarray(mask), apply_mask=True, deterministic=True)
    enc = _port_encoder(params, avg_blocks=2)
    with torch.no_grad():
        got, sel = enc(torch.from_numpy(mel), torch.from_numpy(LENGTHS),
                       torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (4, 25, 64)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    assert _rel(got.numpy(), np.asarray(want)) < 1e-5
    # the target replaces the final norm: neither encoder holds one
    assert "norm" not in params
    assert not [k for k in enc.state_dict() if k.startswith("norm")]


def _jax_d2v_teacher(enc, params, mel, lengths, avg_blocks):
    """The bf16 data2vec teacher of JAX as it runs on a TPU (run_blocks
    takes the block kernels), composed from its parts."""
    x, plen = enc.apply({"params": params}, jnp.asarray(mel),
                        jnp.asarray(lengths), None, False,
                        method=enc.prepare_tokens)
    assert x.dtype == jnp.bfloat16
    _, collected = jpb.encoder_blocks_infer(
        params, x, plen, enc.num_heads, enc.depth, eps=enc.eps,
        collect_from=enc.depth - avg_blocks, interpret=True)

    def inst_norm(h):  # models/atst.py:354-357
        mu = jnp.mean(h, axis=1, keepdims=True)
        var = jnp.var(h, axis=1, keepdims=True)
        return (h - mu) / jnp.sqrt(var + 1e-5)

    out = jnp.mean(jnp.stack([inst_norm(h) for h in collected]), axis=0)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("avg_blocks", [1, 2])
def test_avg_blocks_teacher_matches_jax_block_kernel_route(avg_blocks):
    rng = np.random.RandomState(1)
    jenc = jatst.frame_ast_tiny(spec_w=T, avg_blocks=avg_blocks,
                                dtype=jnp.bfloat16, fused_attention=True,
                                fused_infer=True, drop_path_rate=0.0)
    params = _encoder_params(jenc, rng)
    mel = rng.randn(4, 64, T).astype(np.float32)
    want = _jax_d2v_teacher(jenc, params, mel, LENGTHS, avg_blocks)
    enc = _port_encoder(params, avg_blocks=avg_blocks, dtype=torch.bfloat16,
                        fused_infer=True)
    assert enc._route == "block_kernels"
    with torch.no_grad():
        got, _ = enc(torch.from_numpy(mel), torch.from_numpy(LENGTHS),
                     apply_mask=False)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rel = _rel(got, want)
    print(f"avg_blocks={avg_blocks} bf16 teacher vs JAX's TPU composition: "
          f"rel L2 {rel}, elements equal {np.mean(got == want)}")
    assert rel <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projector_linear_matches_flax_dense(dtype):
    rng = np.random.RandomState(2)
    jdt = jnp.dtype(dtype)
    head = jbyol.Projector(embed_dim=64, projector="linear", predictor=False,
                           dtype=jdt)
    x = rng.randn(3, 7, 64).astype(np.float32)
    params = head.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    params = {"projector_linear": {
        "kernel": params["projector_linear"]["kernel"],
        "bias": jnp.asarray(rng.randn(64).astype(np.float32))}}
    want = head.apply({"params": params}, jnp.asarray(x).astype(jdt))
    assert want.dtype == jdt
    port = Projector(64, predictor=False, projector="linear")
    sd = ck.branch_state_from_flax({"encoder": {}, "head": params})
    assert set(sd) == {"head.projector_linear.weight",
                       "head.projector_linear.bias"}
    port.load_state_dict({k[len("head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x), dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    assert _rel(got.float().numpy(), want) <= (
        1e-6 if dtype == "float32" else 4e-3)
    empty = Projector(64, predictor=False, projector="none")
    assert not list(empty.parameters())
    assert empty(torch.from_numpy(x)) is not None


VARIANTS = {"d2v": dict(avg_blocks=2), "interpolate": dict(
    pos_type="interpolate")}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant_step(request):
    """One frame-tiny step of JAX and of the port, the JAX state bridged,
    JAX's draws handed in (``test_torch_pretrain.one_step`` for a
    variant)."""
    kw = VARIANTS[request.param]
    B, L = tp.B, tp.L
    rng = np.random.RandomState(0)
    wav = (rng.randn(B, L) * 0.1).astype(np.float32)
    for i, v in enumerate(tp.VALID):
        wav[i, v:] = 0.0
    batch = {"wav": jnp.asarray(wav), "valid": jnp.asarray(tp.VALID)}
    m = jm.FrameMethod(jm.FramePretrainConfig(
        arch="tiny", anchor_len=1.0, optimizer=jpt.OptimizerConfig(**tp.OPT),
        **kw))
    m.student = m.student.clone(
        encoder=m.student.encoder.clone(drop_path_rate=0.0))
    m.teacher = m.teacher.clone(
        encoder=m.teacher.encoder.clone(drop_path_rate=0.0))
    state = m.init_state(jax.random.PRNGKey(0))
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))
    params = traverse_util.unflatten_dict(
        {k: (v + 0.05 * jax.random.normal(next(keys), v.shape)
             if k[-1] in ("bias", "scale") else v)
         for k, v in traverse_util.flatten_dict(state.params).items()})
    state = state._replace(
        params=params,
        teacher_params=jpt.copy_into_structure(state.teacher_params, params))
    _, step_rng = jax.random.split(state.rng)

    new_state, metrics = jax.jit(m.make_step())(state, batch)
    # Adam's first moment after one step from zero is (1 - b1) g
    grads = jax.tree.map(lambda mu: mu / (1.0 - jpt.OptimizerConfig().b1),
                         new_state.opt_state.mu)

    method = tm.FrameMethod(tm.FramePretrainConfig(
        arch="tiny", anchor_len=1.0, drop_path_rate=0.0,
        optimizer=tpt.OptimizerConfig(**tp.OPT), **kw), device="cpu")
    pstate = ck.pretrain_state_from_flax(state, method,
                                         torch.Generator().manual_seed(0))
    before = {k: v.detach().clone()
              for k, v in pstate.student.state_dict().items()}
    out = method.make_step()(pstate, {"wav": torch.from_numpy(wav),
                                      "valid": torch.from_numpy(tp.VALID)},
                             tp._jax_draws(step_rng, m.cfg))
    return dict(name=request.param, jax_loss=float(metrics["loss"]),
                jax_grads=grads,
                jax_new=new_state, port=pstate, port_out=out, before=before)


def test_variant_branches_are_jax_branches(variant_step):
    port = variant_step["port"]
    d2v = variant_step["name"] == "d2v"
    assert (port.student.head.projector_linear is not None) == d2v
    assert (port.student.head.predictor is None) == d2v
    assert (port.teacher.encoder.avg_blocks == 2) == d2v
    if d2v:  # the teacher holds no head and no final norm
        assert not list(port.teacher.head.parameters())
        assert [t is None for t in port.teacher_leaves] == [
            k.startswith(("head.", "encoder.norm_frame.")) for k in port.mu]


def test_variant_step_matches_jax(variant_step):
    s = variant_step
    assert float(s["port_out"]["loss"]) == pytest.approx(s["jax_loss"],
                                                         rel=1e-5)
    port, new = s["port"], s["jax_new"]
    grads = ck.branch_state_from_flax(ck._tree_np(s["jax_grads"]))
    params = dict(port.student.named_parameters())
    assert set(grads) == set(params)
    zero = set() if s["name"] == "d2v" else {tp.ZERO_GRAD}
    gmax = max(float(v.norm()) for v in grads.values())
    bad = []
    for k, p in params.items():
        if k in zero:
            assert max(float(p.grad.norm()),
                       float(grads[k].norm())) < 1e-6 * gmax
        elif _rel(p.grad.numpy(), grads[k].numpy()) >= 1e-4:
            bad.append(("grad", k, _rel(p.grad.numpy(), grads[k].numpy())))
    mu, nu, count = ck.opt_state_from_flax(new.opt_state._replace(
        mu=ck._tree_np(new.opt_state.mu), nu=ck._tree_np(new.opt_state.nu)))
    assert port.count == count == 1 and port.step == int(new.step) == 1
    for k in mu:
        if k in zero:
            continue
        for name, a, b in (("mu", port.mu[k], mu[k]),
                           ("nu", port.nu[k], nu[k])):
            if _rel(a.numpy(), b.numpy()) >= 1e-4:
                bad.append((name, k, _rel(a.numpy(), b.numpy())))
    want = ck.branch_state_from_flax(ck._tree_np(new.params),
                                     ck._tree_np(new.batch_stats))
    lr = tp.OPT["learning_rate"]
    for k, v in port.student.state_dict().items():
        if "running" in k:
            if _rel(v.numpy(), want[k].numpy()) >= 1e-4:
                bad.append(("stats", k, _rel(v.numpy(), want[k].numpy())))
            continue
        d_got = (v - s["before"][k]).numpy()
        d_want = want[k].numpy() - s["before"][k].numpy()
        assert np.abs(d_got - d_want).max() <= 0.1 * lr, k
        if k in zero:
            continue
        big = np.abs(grads[k].numpy()) >= 10 * tpt.OptimizerConfig().eps
        if _rel(d_got[big], d_want[big]) >= 1e-3:
            bad.append(("update", k, _rel(d_got[big], d_want[big])))
    t_want = ck.branch_state_from_flax(ck._tree_np(new.teacher_params),
                                       ck._tree_np(new.teacher_batch_stats))
    t_got = port.teacher.state_dict()
    assert set(t_got) == set(t_want)
    for k, v in t_got.items():
        if k not in zero and _rel(v.numpy(), t_want[k].numpy()) >= 1e-6:
            bad.append(("teacher", k, _rel(v.numpy(), t_want[k].numpy())))
    assert not bad, bad
