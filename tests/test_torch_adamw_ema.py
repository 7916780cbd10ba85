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
                                     cfg.eps), tae.LeafTable())
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


# Leaves of lengths that are not multiples of 4 or of a chunk, 1-D ones, a
# one-element leaf, and leaves the teacher does not hold
ODD_SHAPES = [(3, 5), (7,), (tae.CHUNK + 1,), (1,), (33, 31), (2, tae.CHUNK)]
ODD_TEACHER = [True, False, True, True, False, True]


def _leaves(shapes, teacher, seed=0):
    g = torch.Generator().manual_seed(seed)
    p, mu, nu = ([torch.randn(s, generator=g) for s in shapes]
                 for _ in range(3))
    t = [torch.randn(s, generator=g) if keep else None
         for s, keep in zip(shapes, teacher)]
    return p, mu, nu, t, [len(s) >= 2 for s in shapes]


def _on_host(monkeypatch):
    """The kernel path's table work on CPU tensors: the pinned upload
    becomes a plain copy and the device checks pass."""
    monkeypatch.setattr(kb, "require_cuda", lambda *a: None)
    monkeypatch.setattr(tae, "to_device",
                        lambda words, out: out.copy_(torch.from_numpy(words)))


@pytest.mark.parametrize("shapes,teacher", [
    (ODD_SHAPES, ODD_TEACHER),
    ([(512,), (256, 512), (300, 300)], [True, True, False])])
def test_leaf_records_match_the_leaves(shapes, teacher):
    """Each leaf's record holds its pointers, its length, its first chunk
    and its decay flag; the chunk -> leaf map gives every chunk of a leaf
    that leaf, and each leaf starts on a chunk of its own."""
    p, mu, nu, t, decay = _leaves(shapes, teacher)
    words, n_chunks = tae.leaf_records(p, mu, nu, t, decay)
    L = len(shapes)
    rec = words[:6 * L].reshape(L, 6)
    chunks = [-(-int(np.prod(s)) // tae.CHUNK) for s in shapes]
    assert n_chunks == sum(chunks)
    np.testing.assert_array_equal(rec[:, 0], [x.data_ptr() for x in p])
    np.testing.assert_array_equal(rec[:, 1], [x.data_ptr() for x in mu])
    np.testing.assert_array_equal(rec[:, 2], [x.data_ptr() for x in nu])
    np.testing.assert_array_equal(
        rec[:, 3], [0 if x is None else x.data_ptr() for x in t])
    np.testing.assert_array_equal(rec[:, 4], [int(np.prod(s)) for s in shapes])
    np.testing.assert_array_equal(rec[:, 5] & 0xFFFFFFFF,
                                  np.cumsum([0] + chunks[:-1]))
    wd = (rec[:, 5] >> 32).astype(np.int32).view(np.float32)
    np.testing.assert_array_equal(wd, np.float32(decay))
    leaf_of = words[6 * L:].view(np.int32)[:n_chunks]
    np.testing.assert_array_equal(leaf_of, np.repeat(np.arange(L), chunks))
    assert len(words) == 6 * L + -(-n_chunks // 2)


def test_leaf_table_is_reused_until_a_leaf_changes(monkeypatch):
    """A second call with the same leaves reuses the device table as it is
    (the same tensor, no rebuild); a leaf with other storage, another
    length or another decay flag rebuilds it."""
    _on_host(monkeypatch)
    built = []
    records = tae.leaf_records
    monkeypatch.setattr(tae, "leaf_records",
                        lambda *a: built.append(1) or records(*a))
    p, mu, nu, t, decay = _leaves(ODD_SHAPES, ODD_TEACHER)
    table = tae.LeafTable()
    table.refresh(p, mu, nu, t, decay)
    first, grads = table.table, table.grads
    assert len(built) == 1 and table.n_chunks == records(
        p, mu, nu, t, decay)[1]
    np.testing.assert_array_equal(first.numpy(),
                                  records(p, mu, nu, t, decay)[0])
    table.refresh(p, mu, nu, t, decay)
    assert len(built) == 1 and table.table is first and table.grads is grads

    nu[2] = torch.zeros_like(nu[2])  # the moment restored into new storage
    table.refresh(p, mu, nu, t, decay)
    assert table.table is not first and len(built) == 2
    np.testing.assert_array_equal(table.table.numpy()[6 * 2 + 2],
                                  nu[2].data_ptr())
    second = table.table
    table.refresh(p, mu, nu, t, [not d for d in decay])
    assert table.table is not second
    third = table.table
    p[0].data = torch.zeros(3, 6)  # a parameter of another length
    mu[0], nu[0], t[0] = (torch.zeros(3, 6) for _ in range(3))
    table.refresh(p, mu, nu, t, decay)
    assert table.table is not third and int(table.table[4]) == 18


def test_kernel_path_launch_is_captured(monkeypatch):
    """On tensors off the CPU the wrapper checks the leaves once, then per
    call uploads the gradients' pointers into the table's own buffer and
    launches K7 once over all leaves with the cached table, its chunk count
    and the f32 scalars. Meta tensors reach the kernel path; the upload
    and the launch are captured instead of run."""
    uploads, launched = [], []
    monkeypatch.setattr(kb, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kb, "ptr", lambda t: t)
    monkeypatch.setattr(kb, "launch",
                        lambda name, dev, *args: launched.append((name, args)))
    monkeypatch.setattr(tae, "to_device",
                        lambda words, out: uploads.append((words, out)))
    meta = torch.device("meta")
    shapes = [(3, 5), (7,), (64, 64)]
    leaf = lambda s: torch.empty(s, device=meta)  # noqa: E731
    p, g, mu, nu = ([leaf(s) for s in shapes] for _ in range(4))
    t = [leaf(shapes[0]), None, leaf(shapes[2])]
    sc = tae.update_scalars(LR, WD, M, 3, 0.9, 0.999, 1e-6)
    table = tae.LeafTable()
    kb.reset_launches()
    for _ in range(2):
        tae.adamw_ema(p, g, mu, nu, t, [True, False, True], sc, table=table)
    assert [n for n, _ in launched] == ["adamw_ema"] * 2
    # the table once, then the gradients' pointers on every call
    assert [out is table.table for _, out in uploads] == [True, False, False]
    assert all(out is table.grads and len(words) == 3
               for words, out in uploads[1:])
    for _, args in launched:
        assert args[0] is table.table and args[1] is table.grads
        assert args[2:4] == (3, 1 + 1 + 2)
        assert args[4:] == tuple(sc[k] for k in (
            "lr", "wd", "m", "one_minus_m", "rc1", "rc2", "b1",
            "one_minus_b1", "b2", "one_minus_b2", "eps"))
    with pytest.raises(ValueError, match="gradient must be f32"):
        tae.adamw_ema(p, [leaf(s) for s in shapes[:2]] + [leaf((64, 63))],
                      mu, nu, t, [True, False, True], sc, table=table)


def test_pretrain_state_pairs_the_update_leaves_once():
    """The step's leaves are paired when the state is made: the student's
    parameters in the moments' order, the teacher's copy of each (none for
    the predictor) and the decay flag of ``wd_mask``."""
    from audiossl_tpu_torch.methods.atstframe.method import (
        FrameMethod, FramePretrainConfig)
    from audiossl_tpu_torch.training import pretrain as tpt

    m = FrameMethod(FramePretrainConfig(arch="small"), device="meta")
    names = [k for k, _ in m.student.named_parameters()]
    mu = {k: torch.empty(0) for k in reversed(names)}
    st = tpt.PretrainState(step=0, student=m.student, teacher=m.teacher,
                           mu=mu, nu=dict(mu), count=0, generator=None)
    sp, tp = dict(m.student.named_parameters()), dict(
        m.teacher.named_parameters())
    mask = tpt.wd_mask(m.student)
    assert all(a is sp[k] for a, k in zip(st.leaves, mu))
    assert all(a is tp.get(k) for a, k in zip(st.teacher_leaves, mu))
    assert st.decay == [mask[k] for k in mu]
    assert any(t is None for t in st.teacher_leaves)  # the predictor
    assert any(st.decay) and not all(st.decay)
