"""Data-parallel pretraining steps of the port on 2 gloo ranks on the CPU,
against the port's one-process step on the global batch and against the
JAX package's step on a 2-device CPU mesh (its batch sharded over
``data_mesh(2)``).

The ranks are spawned once for the file (``parallel.launch.spawn``, a hard
limit of 240 s) and run every case; each writes its results, and the
tests read them. The global batch is 4 clips, 2 a rank, of
``test_torch_pretrain.py``'s frame-tiny and ``test_torch_clip.py``'s
clip-tiny steps (f32, drop-path 0) with JAX's draws handed in: the valid
lengths [20000, 18000 | 16000, 12000] leave the ranks with unequal
counts of selected frames, and mixup's partners ``(i + shift) % 4`` cross
ranks. A frame step with drop-path 0.5 and the port's own draws holds the
view-major split of the drop-path multipliers.

Tolerances: against the one-process step, loss rel 1e-6, each branch's
values rel L2 1e-5 and the whole gradient 1e-5 or three times what the
row order alone moves it by (each leaf 1e-4;
``test_two_rank_step_matches_one_process_step``); against JAX's step on
the mesh, ``test_torch_pretrain.py``'s: loss rel 1e-5,
gradients (JAX's first moments over 1 - b1) and moments rel L2 1e-4. The
final LayerNorm's bias has no gradient in exact arithmetic: it is held to
a vanishing gradient. ZeRO-1 is held bit for bit to the replicated step,
and both ranks' parameters and BatchNorm statistics to each other. Unit
cases hold the global BatchNorm (its output, gradients and running
statistics), the masked pair loss with unequal counts, the feature std
and mixup across ranks against one process on the global batch.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from audiossl_tpu_torch.methods.atst import method as tcm
from audiossl_tpu_torch.methods.atstframe import method as tfm
from audiossl_tpu_torch.models.byol import byol_pair_loss, feature_std
from audiossl_tpu_torch.models.norm import BatchNorm1d
from audiossl_tpu_torch.parallel import launch
from audiossl_tpu_torch.parallel.mesh import (all_reduce_sum, local_rows,
                                              reduce_grads, world)
from audiossl_tpu_torch.training import checkpoint as tck
from audiossl_tpu_torch.training import pretrain as tpt
from audiossl_tpu_torch.transforms.augment import mixup_log

N_RANKS, B = 2, 4
OPT = dict(learning_rate=5e-4, warmup_steps=0, max_steps=1000, ema=0.99)
ZERO_GRAD = {"frame": "encoder.norm_frame.bias", "clip": "encoder.norm.bias"}
CASES = ("frame_jax", "frame_dp", "clip_jax")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _method(case):
    if case.startswith("frame"):
        return tfm.FrameMethod(tfm.FramePretrainConfig(
            arch="tiny", anchor_len=1.0,
            drop_path_rate=0.5 if case == "frame_dp" else 0.0,
            optimizer=tpt.OptimizerConfig(**OPT)), device="cpu", seed=3)
    return tcm.ClipMethod(tcm.ClipPretrainConfig(
        arch="tiny", anchor_len=(1.0, 1.0), positive_len=(1.0, 1.0),
        drop_path_rate=0.0, optimizer=tpt.OptimizerConfig(**OPT)),
        device="cpu")


def _step(case, inputs, rows, zero=False):
    """One step of ``case`` from the saved state on ``rows`` of the global
    batch with the global draws: (metrics, student gradients, state)."""
    method = _method(case)
    state = method.init_state(0)
    tck.load_host_state(state, inputs[case]["state"])
    if zero:
        tpt.shard_optimizer(state)
    batch = {k: v[rows] for k, v in inputs[case]["batch"].items()}
    out = method.make_step()(state, batch, inputs[case]["draws"])
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for k, p in state.student.named_parameters()}
    return {k: float(v) for k, v in out.items()}, grads, state


def _snapshot(out, grads, state):
    return dict(metrics=out, grads=grads,
                student={k: v.clone() for k, v in
                         state.student.state_dict().items()},
                teacher={k: v.clone() for k, v in
                         state.teacher.state_dict().items()},
                mu={k: v.clone() for k, v in state.mu.items()},
                nu={k: v.clone() for k, v in state.nu.items()})


def _units(u):
    """This rank's part of the unit cases on its rows of ``u``'s global
    tensors."""
    sl = local_rows(u["x"].shape[0])
    bn = BatchNorm1d(u["x"].shape[-1])
    with torch.no_grad():
        bn.weight.copy_(u["bn_w"])
        bn.bias.copy_(u["bn_b"])
    x = u["x"][sl].clone().requires_grad_(True)
    y = bn(x, u["mask"][sl])
    (y * u["gy"][sl]).sum().backward()
    reduce_grads([bn.weight, bn.bias])
    p = u["p"][sl].clone().requires_grad_(True)
    share = byol_pair_loss(p, u["z"][sl], u["mask"][sl])
    share.backward()
    return dict(bn_y=y.detach(), bn_dx=x.grad, bn_dw=bn.weight.grad,
                bn_db=bn.bias.grad, bn_mean=bn.running_mean,
                bn_var=bn.running_var, share=share.detach(),
                loss=all_reduce_sum(share.detach()), dp=p.grad,
                std=feature_std(u["p"][sl], u["mask"][sl]),
                mix=mixup_log(u["spec"][sl], u["a"][sl], u["shift"][sl],
                              valid_frames=u["frames"][sl]))


def _ranks(workdir):
    """Every case on this rank; its results to ``rank<r>.pt``."""
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    rows = local_rows(B)
    res = {"units": _units(inputs["units"])}
    for case in CASES:
        res[case] = _snapshot(*_step(case, inputs, rows))
        if case != "frame_dp":
            res[case + "_zero1"] = _snapshot(*_step(case, inputs, rows,
                                                    zero=True))
    torch.save(res, os.path.join(workdir, f"rank{world().rank}.pt"))


def _unit_inputs():
    rng = np.random.RandomState(21)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    mask = torch.zeros(8, 5, dtype=torch.bool)
    mask[:4] = torch.from_numpy(rng.rand(4, 5) < 0.9)  # rank 0: most rows
    mask[4:] = torch.from_numpy(rng.rand(4, 5) < 0.2)  # rank 1: few
    mask[5, 0] = True
    return dict(x=t(8, 5, 16) * 2 + 0.5, gy=t(8, 5, 16), mask=mask,
                bn_w=t(16) * 0.1 + 1, bn_b=t(16) * 0.1, p=t(8, 5, 16),
                z=t(8, 5, 16), spec=t(8, 4, 10),
                a=torch.from_numpy(rng.rand(8).astype(np.float32) * 0.4),
                # partners (i + shift) % 8 on the other rank for most rows
                shift=torch.tensor([4, 5, 6, 1, 3, 7, 2, 4]),
                frames=torch.tensor([10, 7, 10, 3, 10, 10, 6, 1]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs of every case (JAX's states and draws rebuilt as
    ``test_torch_pretrain.py`` and ``test_torch_clip.py`` rebuild them),
    the ranks' results, and the JAX steps on a 2-device mesh."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import test_torch_clip as tc
    import test_torch_pretrain as tp
    from audiossl_tpu.parallel import data_mesh
    from audiossl_tpu.training import pretrain as jpt
    from audiossl_tpu_torch.compat import checkpoint as ck

    workdir = str(tmp_path_factory.mktemp("ddp"))
    rng = np.random.RandomState(0)
    wav = (rng.randn(B, tp.L) * 0.1).astype(np.float32)
    for i, v in enumerate(tp.VALID):
        wav[i, v:] = 0.0
    batch = {"wav": torch.from_numpy(wav),
             "valid": torch.from_numpy(tp.VALID)}
    jbatch = {"wav": jnp.asarray(wav), "valid": jnp.asarray(tp.VALID)}

    def nudged(m, key):
        from flax import traverse_util

        state = m.init_state(jax.random.PRNGKey(key))
        keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))

        def nudge(path, p):
            if path[-1] in ("bias", "scale"):
                return p + 0.05 * jax.random.normal(next(keys), p.shape)
            return p

        params = traverse_util.unflatten_dict(
            {k: nudge(k, v) for k, v in
             traverse_util.flatten_dict(state.params).items()})
        return state._replace(
            params=params, teacher_params=jpt.copy_into_structure(
                state.teacher_params, params))

    mesh = data_mesh(N_RANKS)
    repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    jaxes, inputs = {}, {"units": _unit_inputs()}
    for case, jm_method in (("frame_jax", tp._jax_method()),
                            ("clip_jax", tc._jax_method((1.0, 1.0)))):
        state = nudged(jm_method, 0)
        _, step_rng = jax.random.split(state.rng)
        if case == "frame_jax":
            draws = tp._jax_draws(step_rng, jm_method.cfg)
        else:
            method = _method(case)
            draws = tc._views_draws(jax.random.split(step_rng, 3)[0],
                                    method.cfg)
        pstate = ck.pretrain_state_from_flax(
            state, _method(case), torch.Generator().manual_seed(0))
        inputs[case] = dict(state=tck.host_state(pstate), batch=batch,
                            draws=draws)
        jaxes[case] = (jm_method, state)
    method = _method("frame_dp")
    inputs["frame_dp"] = dict(
        state=tck.host_state(method.init_state(0)), batch=batch,
        draws=method.draw(torch.Generator().manual_seed(6), B))
    assert bool((inputs["frame_dp"]["draws"].student_dp == 0).any())
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))

    launch.spawn(_ranks, N_RANKS, (workdir,), device="cpu", timeout_s=240)
    got = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                      weights_only=False) for r in range(N_RANKS)]

    one = {case: _snapshot(*_step(case, inputs, slice(None)))
           for case in CASES}
    swapped = {case: _swapped(case, inputs[case]) for case in CASES}
    witness = {case: _snapshot(*_step(case, swapped, slice(None)))
               for case in CASES}
    jax_new = {}
    for case, (jm_method, state) in jaxes.items():
        new, metrics = jax.jit(jm_method.make_step())(
            jax.device_put(state, repl), jax.device_put(jbatch, shard))
        mu, nu, _ = ck.opt_state_from_flax(new.opt_state._replace(
            mu=ck._tree_np(new.opt_state.mu),
            nu=ck._tree_np(new.opt_state.nu)))
        jax_new[case] = dict(loss=float(metrics["loss"]), mu=mu, nu=nu)
    return dict(inputs=inputs, got=got, one=one, witness=witness,
                jax=jax_new)


def _which(case):
    return "frame" if case.startswith("frame") else "clip"


def _flat(tensors, keys):
    return torch.cat([tensors[k].double().flatten() for k in keys])


SWAP = [2, 3, 0, 1]  # the ranks' halves of the global batch exchanged


def _swapped(case, inp):
    """``inp`` with the rows of its batch in the order ``SWAP`` and its
    draws to match: each clip keeps its own draws and its mixup partner
    (the shift re-aimed at the partner's new row)."""
    perm = torch.tensor(SWAP)
    inv = torch.argsort(perm)

    def rows(t):
        return None if t is None else t[perm]

    def mix(m):
        if m is None:
            return None
        a, shift = m
        partner = (perm + shift[perm]) % B
        return a[perm], (inv[partner] - torch.arange(B)) % B

    def dp(m):
        return None if m is None else torch.cat(
            [m[..., :B][..., perm], m[..., B:][..., perm]], -1)

    d = inp["draws"]
    if case.startswith("frame"):
        draws = tfm.StepDraws(
            crop=rows(d.crop), mix=tuple(mix(m) for m in d.mix),
            rrc=tuple(None if r is None else tuple(map(rows, r))
                      for r in d.rrc),
            mask={k: rows(v) for k, v in d.mask.items()},
            student_dp=dp(d.student_dp), teacher_dp=dp(d.teacher_dp))
    else:
        draws = tcm.ClipStepDraws(
            views=tuple(tcm.ViewDraws(
                crop_len=rows(v.crop_len), crop=rows(v.crop),
                mix=mix(v.mix), rrc=tuple(map(rows, v.rrc)))
                for v in d.views),
            student_dp=dp(d.student_dp), teacher_dp=dp(d.teacher_dp))
    return dict(state=inp["state"], draws=draws,
                batch={k: rows(v) for k, v in inp["batch"].items()})


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_one_process_step(ranks, case):
    """Loss rel 1e-6; each branch's values rel L2 1e-5 (each leaf 1e-4:
    Adam's first step divides a gradient element by its own scale, which
    magnifies the rounding of gradients near eps); each gradient leaf rel
    L2 1e-4, the whole gradient 1e-5 or, where f32 rounding alone moves
    it further, three times the distance between two one-process steps
    that differ only in the order of their rows (the ranks' halves
    swapped). Behind the projector's BatchNorm a leaf's gradient sums
    terms that cancel: the row order alone moves the frame-tiny and
    clip-tiny gradients by 2.7e-6 to 5.3e-6, and the two ranks' partial
    sums add a second rounding. The zero-grad leaf's values move by a step
    of rounding noise: at most lr on either path (the teacher's
    (1 - ema) lr)."""
    one = ranks["one"][case]
    wit = ranks["witness"][case]
    zero = ZERO_GRAD[_which(case)]
    lr, ema = OPT["learning_rate"], OPT["ema"]
    keys = [k for k in one["grads"] if k != zero]
    floor = _rel(_flat(wit["grads"], keys), _flat(one["grads"], keys))
    assert wit["metrics"]["loss"] == pytest.approx(one["metrics"]["loss"],
                                                   rel=1e-6)
    for r, got in enumerate(ranks["got"]):
        g = got[case]
        assert g["metrics"]["loss"] == pytest.approx(
            one["metrics"]["loss"], rel=1e-6), r
        for k in one["metrics"]:
            assert g["metrics"][k] == pytest.approx(one["metrics"][k],
                                                    rel=1e-5), (r, k)
        gmax = max(float(v.norm()) for v in one["grads"].values())
        assert float(g["grads"][zero].norm()) < 1e-6 * gmax
        dist = _rel(_flat(g["grads"], keys), _flat(one["grads"], keys))
        assert dist < max(1e-5, 3 * floor), (dist, floor)
        bad = [("grad", k, err) for k in keys
               if (err := _rel(g["grads"][k], one["grads"][k])) >= 1e-4]
        for branch, noise in (("student", 2 * lr),
                              ("teacher", 2 * lr * (1 - ema))):
            vkeys = [k for k in one[branch] if k != zero]
            assert _rel(_flat(g[branch], vkeys),
                        _flat(one[branch], vkeys)) < 1e-5, branch
            assert float((g[branch][zero] - one[branch][zero]).abs().max()
                         ) <= noise, branch
            bad += [(branch, k, err) for k in vkeys
                    if (err := _rel(g[branch][k], one[branch][k])) >= 1e-4]
        assert not bad, (r, bad)


@pytest.mark.parametrize("case", ["frame_jax", "clip_jax"])
def test_two_rank_step_matches_jax_on_a_two_device_mesh(ranks, case):
    want = ranks["jax"][case]
    b1 = tpt.OptimizerConfig().b1
    zero = ZERO_GRAD[_which(case)]
    for r, got in enumerate(ranks["got"]):
        g = got[case]
        assert g["metrics"]["loss"] == pytest.approx(want["loss"], rel=1e-5)
        mmax = max(float(v.norm()) for v in want["mu"].values())
        bad = []
        for k, mu in want["mu"].items():
            if k == zero:
                assert float(g["grads"][k].norm()) * (1 - b1) < 1e-6 * mmax
                continue
            if not mu.any():
                assert not g["grads"][k].any(), k  # clip's mask_embed
                continue
            for name, a, b in (("grad", g["grads"][k], mu / (1 - b1)),
                               ("mu", g["mu"][k], mu),
                               ("nu", g["nu"][k], want["nu"][k])):
                if _rel(a, b) >= 1e-4:
                    bad.append((name, k, _rel(a, b)))
        assert not bad, (r, bad)


@pytest.mark.parametrize("case", CASES)
def test_both_ranks_hold_the_same_parameters_and_bn_statistics(ranks, case):
    a, b = (got[case] for got in ranks["got"])
    for branch in ("student", "teacher"):
        assert a[branch].keys() == b[branch].keys()
        for k in a[branch]:
            assert torch.equal(a[branch][k], b[branch][k]), (branch, k)
    assert any("running_var" in k for k in a["teacher"])
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k
    assert a["metrics"] == b["metrics"]


@pytest.mark.parametrize("case", ["frame_jax", "clip_jax"])
def test_zero1_is_bit_equal_to_replicated(ranks, case):
    n_leaves = len(ranks["got"][0][case]["mu"])
    owned = []
    for got in ranks["got"]:
        rep, zero = got[case], got[case + "_zero1"]
        assert zero["metrics"] == rep["metrics"]
        for branch in ("student", "teacher"):
            for k, v in rep[branch].items():
                assert torch.equal(zero[branch][k], v), (branch, k)
        for k in zero["mu"]:
            assert torch.equal(zero["mu"][k], rep["mu"][k]), k
            assert torch.equal(zero["nu"][k], rep["nu"][k]), k
        owned.append(set(zero["mu"]))
    assert owned[0].isdisjoint(owned[1])
    assert len(owned[0] | owned[1]) == n_leaves
    assert all(owned), "a rank owns no leaf"


def test_frame_step_ranks_have_unequal_selected_counts(ranks):
    """The valid lengths leave the two ranks different numbers of valid
    tokens, so the masked means must take the global count."""
    method = _method("frame_jax")
    inp = ranks["inputs"]["frame_jax"]
    draws = tfm.local_draws(inp["draws"], B)
    _, frames, mask = tfm.frame_train_views(
        inp["batch"]["wav"], inp["batch"]["valid"].long(), method.cfg, draws)
    valid_tokens = frames[:B] // method.cfg.patch_w
    sel = [int(((mask[:B] & (torch.arange(mask.shape[1])[None]
                              < valid_tokens[:, None]))[rows]).sum())
           for rows in (slice(0, 2), slice(2, 4))]
    assert sel[0] != sel[1], sel
    shift = inp["draws"].mix[1][1]
    partner = (torch.arange(B) + shift) % B
    assert bool(((partner // 2) != (torch.arange(B) // 2)).any())


def test_units_match_one_process_on_the_global_batch(ranks):
    u = ranks["inputs"]["units"]
    counts = [int(u["mask"][rows].sum()) for rows in (slice(0, 4),
                                                      slice(4, 8))]
    assert counts[0] > 2 * counts[1] > 0, counts
    partner = (torch.arange(8) + u["shift"]) % 8
    assert int(((partner // 4) != (torch.arange(8) // 4)).sum()) >= 5
    bn = BatchNorm1d(16)
    with torch.no_grad():
        bn.weight.copy_(u["bn_w"])
        bn.bias.copy_(u["bn_b"])
    x = u["x"].clone().requires_grad_(True)
    y = bn(x, u["mask"])
    (y * u["gy"]).sum().backward()
    p = u["p"].clone().requires_grad_(True)
    loss = byol_pair_loss(p, u["z"], u["mask"])
    loss.backward()
    std = feature_std(u["p"], u["mask"])
    mix = mixup_log(u["spec"], u["a"], u["shift"], valid_frames=u["frames"])
    shares = []
    for r, got in enumerate(ranks["got"]):
        g, rows = got["units"], slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(g["bn_y"], y[rows].detach(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g["bn_dx"], x.grad[rows], rtol=1e-5,
                                   atol=1e-5)
        assert _rel(g["bn_dw"], bn.weight.grad) < 1e-5
        assert _rel(g["bn_db"], bn.bias.grad) < 1e-5
        assert _rel(g["bn_mean"], bn.running_mean) < 1e-6
        assert _rel(g["bn_var"], bn.running_var) < 1e-6
        assert float(g["loss"]) == pytest.approx(float(loss), rel=1e-6)
        np.testing.assert_allclose(g["dp"], p.grad[rows], rtol=1e-5,
                                   atol=1e-7)
        assert float(g["std"]) == pytest.approx(float(std), rel=1e-6)
        np.testing.assert_allclose(g["mix"], mix[rows], rtol=1e-6,
                                   atol=1e-6)
        shares.append(float(g["share"]))
    assert sum(shares) == pytest.approx(float(loss), rel=1e-6)
    assert shares[0] != pytest.approx(shares[1], rel=1e-3)


def test_local_draws_split_the_view_major_drop_path(monkeypatch):
    """Each rank's draws: its clips' rows, and its rows of each view of
    the drop-path multipliers [depth, 2, 2B], still view-major."""
    method = _method("frame_dp")
    draws = method.draw(torch.Generator().manual_seed(1), B)
    assert draws.student_dp.shape[-1] == 2 * B
    monkeypatch.setattr(tfm, "world", lambda: dataclasses.replace(
        world(), size=N_RANKS))
    for rows, cols in ((slice(0, 2), [0, 1, 4, 5]),
                       (slice(2, 4), [2, 3, 6, 7])):
        monkeypatch.setattr(tfm, "local_rows", lambda n, _r=rows: _r)
        got = tfm.local_draws(draws, B)
        assert torch.equal(got.student_dp, draws.student_dp[..., cols])
        assert torch.equal(got.teacher_dp, draws.teacher_dp[..., cols])
        assert torch.equal(got.crop, draws.crop[rows])
        for k, v in draws.mask.items():
            assert torch.equal(got.mask[k], v[rows])
        for g, d in zip(got.mix, draws.mix):
            assert all(torch.equal(a, b[rows]) for a, b in zip(g, d))
