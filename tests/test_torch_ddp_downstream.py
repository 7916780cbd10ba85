"""Data-parallel downstream steps of the port on 2 gloo ranks on the CPU,
against the port's one-process step on the global batch and against the
JAX package's jitted step on a 2-device CPU mesh (its batch sharded by
``maybe_shard_batch`` over ``data_mesh(2)``).

The ranks are spawned once for the file (``parallel.launch.spawn``, a hard
limit of 240 s) and run every case while JAX's steps compile here; each
writes its results, and the tests read them. Each rank steps on its rows
of the global batch (``parallel.shard_batch``) with the global batch's
draws:

* two finetuning steps of ``test_torch_finetune.py``'s cases from the
  same JAX state with JAX's draws: clip-tiny (chunked, multi-label BCE,
  mixup, SpecAugment, RandomResizeCrop, ``freeze_embed``) and frame-tiny
  (CE, ``mixup_ratio`` 0.5), 4 clips, 2 a rank, mixup's partners crossing
  ranks; a clip-tiny step with drop path 0.5 and the port's own draws
  holds the clip-major split of the chunk sequences' uniforms;
* two SED steps of ``test_torch_sed_task.py``'s cases (JAX's drop-path
  uniforms handed in): the DCASE step with ``SEDHead(use_norm=True)``,
  the AudioSet-strong layer decay and freeze mode, on its batch of 4
  strong then 4 weak rows, so rank 0 holds only strong rows and rank 1
  only weak ones;
* units: the global ``SEDHead`` norm (output and gradients); a ragged
  batch of 3 under the replicated fallback (``parallel.batch_rows``),
  its step and BatchNorm running statistics equal to one process's;
  sharded extraction (``extract_split``) with a ragged last batch; the
  keeper writing on rank 0 alone and restoring the same state on both.

Tolerances: against the one-process step, loss rel 1e-6, the other
logged values (the gradient norm, the SED losses) rel 1e-5, each parameter
and the momentum trace rel L2 1e-5, all or three times what the row order
alone moves them (the one-process step with the ranks' halves swapped:
PR 15's rule); against JAX on the mesh, ``test_torch_finetune.py``'s and
``test_torch_sed_task.py``'s: loss rel 1e-5, parameters and trace rtol
1e-5, atol 2e-5. Both ranks hold the same state after the steps, bit for
bit.
"""
import builtins
import os
import threading

import numpy as np
import pytest
import torch

from audiossl_tpu_torch.downstream import finetune as tft
from audiossl_tpu_torch.downstream.embedding import (extract_split,
                                                     make_clip_extractor)
from audiossl_tpu_torch.models import atst as tatst
from audiossl_tpu_torch.parallel import launch
from audiossl_tpu_torch.parallel.mesh import (batch_rows, local_rows,
                                              reduce_grads, shard_batch,
                                              world)
from audiossl_tpu_torch.sed import module as tsed
from audiossl_tpu_torch.sed.head import SEDHead
from audiossl_tpu_torch.training.checkpoint import TopKKeeper

N_RANKS = 2
SPAWN_S = 240
FT_CASES = ("clip_sgd", "frame_sgd")
SED_CASES = ("dcase", "lr_scale", "freeze")
W = 101  # the encoders' mel frames (spec_w)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ #
# the tasks, built alike in the parent and on the ranks
# ------------------------------------------------------------------ #
def ft_task(spec):
    enc = getattr(tatst, spec["maker"])(spec_w=W, device="cpu")
    return tft.FinetuneTask(enc, tft.FinetuneConfig(**spec["cfg"]),
                            spec["embed"])


def sed_task(spec):
    task = tsed.SEDTask(tatst.frame_ast_tiny(spec_w=W, device="cpu"),
                        tsed.SEDConfig(**spec["cfg"]))
    task.head.use_norm = spec["use_norm"]
    return task


def load(task, saved):
    """A state of ``task`` holding ``saved`` (:func:`snapshot`'s)."""
    task.encoder.load_state_dict(saved["encoder"])
    task.head.load_state_dict(saved["head"])
    state = task.init_state()
    for k, v in saved["mu"].items():
        state.mu[k].copy_(v)
    state.step = saved["step"]
    return state


def snapshot(state, metrics=()):
    return dict(encoder={k: v.clone() for k, v in
                         state.encoder.state_dict().items()},
                head={k: v.clone() for k, v in
                      state.head.state_dict().items()},
                mu={k: v.clone() for k, v in state.mu.items()},
                step=state.step,
                metrics=[{k: float(v) for k, v in m.items()}
                         for m in metrics])


def run_case(kind, inp, rows=None):
    """``inp``'s steps from its state; each step on this rank's rows of
    its global batch (``rows`` None) or on ``rows`` of it in one process,
    with the global draws."""
    task = (ft_task if kind == "ft" else sed_task)(inp["spec"])
    state = load(task, inp["state"])
    metrics = []
    for batch, draws in zip(inp["batches"], inp["draws"]):
        local = shard_batch(batch) if rows is None else \
            {k: v[rows] for k, v in batch.items()}
        state, m = task.train_step(state, local, draws)
        metrics.append(m)
    return snapshot(state, metrics)


# ------------------------------------------------------------------ #
# units
# ------------------------------------------------------------------ #
def unit_inputs():
    rng = np.random.RandomState(31)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    enc = tatst.ast_tiny(spec_w=1001, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    wav = (rng.randn(7, 16000) * 0.1).astype(np.float32)
    valid = np.asarray([16000, 9000, 12000, 16000, 5000, 16000, 11000],
                       np.int32)
    return dict(
        x=t(4, 6, 16) * 2 + 0.5, gy=t(4, 3, 6), gw=t(4, 3),
        head=SEDHead(16, 3, use_norm=True,
                     generator=torch.Generator().manual_seed(1)).state_dict(),
        encoder=enc.state_dict(),
        # a batch of 4, then a ragged one of 3
        loader=[{"wav": wav[:4], "valid": valid[:4], "label": np.arange(4)},
                {"wav": wav[4:], "valid": valid[4:],
                 "label": np.arange(4, 7)}])


def units(u, workdir):
    """This rank's part of the unit cases."""
    head = SEDHead(16, 3, use_norm=True)
    head.load_state_dict(u["head"])
    sl = local_rows(u["x"].shape[0])
    x = u["x"][sl].clone().requires_grad_(True)
    strong, weak = head(x)
    ((strong * u["gy"][sl]).sum() + (weak * u["gw"][sl]).sum()).backward()
    reduce_grads(list(head.parameters()))
    enc = tatst.ast_tiny(spec_w=1001, device="cpu")
    enc.load_state_dict(u["encoder"])
    emb, labels = extract_split(
        make_clip_extractor(enc.eval(), crop_len_s=1.0, n_blocks=2,
                            chunk_len=61), u["loader"])
    writes = []
    save = torch.save
    opened = builtins.open

    def record_save(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)):  # not the broadcast's buffer
            writes.append(str(f))
        return save(obj, f, *a, **k)

    def record_open(f, mode="r", *a, **k):
        if any(c in mode for c in "wax") and isinstance(f, (str,
                                                           os.PathLike)):
            writes.append(str(f))
        return opened(f, mode, *a, **k)

    torch.save, builtins.open = record_save, record_open
    try:
        keeper = TopKKeeper(os.path.join(workdir, "keeper"), k=2)
        for tag, metric in enumerate([0.3, 0.7, 0.5]):
            keeper.update(metric, tag, {"w": torch.full((2,), float(tag))})
        best = keeper.restore_best()
    finally:
        torch.save, builtins.open = save, opened
    return dict(strong=strong.detach(), weak=weak.detach(), dx=x.grad,
                dw={k: p.grad for k, p in head.named_parameters()},
                emb=emb, labels=labels, writes=writes, best=best)


def ragged_step(inp):
    """The frame finetuning steps on batches of 3 clips, which do not
    divide over 2 ranks: each run whole on each rank (``batch_rows``)."""
    task = ft_task(inp["spec"])
    state = load(task, inp["state"])
    metrics = []
    for batch, draws in zip(inp["batches"], inp["draws"]):
        with batch_rows(batch) as rows:
            state, m = task.train_step(state, rows, draws)
        metrics.append(m)
    return snapshot(state, metrics)


def ranks_main(workdir):
    """Every case on this rank; its results to ``rank<r>.pt``."""
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    res = {case: run_case("ft", inputs[case]) for case in
           (*FT_CASES, "clip_dp")}
    res.update((case, run_case("sed", inputs[case])) for case in SED_CASES)
    res["ragged"] = ragged_step(inputs["ragged"])
    res["units"] = units(inputs["units"], workdir)
    torch.save(res, os.path.join(workdir, f"rank{world().rank}.pt"))


# ------------------------------------------------------------------ #
# the inputs, the one-process and JAX steps
# ------------------------------------------------------------------ #
def _swap(batch, draws, kind, half):
    """The batch with its halves exchanged and the draws to match: each
    clip keeps its own draws; a roll by ``shift`` keeps its partners,
    since exchanging the halves is itself a roll."""
    n = 2 * half
    perm = torch.tensor([(i + half) % n for i in range(n)])
    b = {k: v[perm.numpy()] for k, v in batch.items()}
    if kind == "sed":
        return b, None if draws is None else draws[..., perm]
    d = draws

    def rows(v):
        if isinstance(v, tuple):
            return tuple(rows(x) for x in v)
        return None if v is None else v[perm]

    dp = None
    if d.dp is not None:
        per = d.dp.shape[-1] // n
        dp = d.dp.reshape(*d.dp.shape[:-1], n, per)[..., perm, :].reshape(
            d.dp.shape)
    return b, tft.FinetuneDraws(lam=rows(d.lam), keep=rows(d.keep),
                                shift=d.shift, freq=rows(d.freq),
                                time=rows(d.time), rrc=rows(d.rrc), dp=dp)


def _ft_inputs(name, jax, jnp, mesh):
    """A finetuning case of ``test_torch_finetune.py``: the port's state
    from JAX's and JAX's draws of two steps (each step's key is the first
    of three split from the last), and a function that runs JAX's two
    steps on the mesh."""
    import test_torch_finetune as tf
    from jax.sharding import NamedSharding, PartitionSpec as P

    from audiossl_tpu.downstream import finetune as jft
    from audiossl_tpu.models import atst as jatst
    from audiossl_tpu.parallel.mesh import maybe_shard_batch
    from audiossl_tpu_torch.compat import checkpoint as ck

    case = tf.CASES[name]
    rng = np.random.RandomState(12)
    batches = [tf._batch(rng, case) for _ in range(2)]
    jcfg = jft.FinetuneConfig(**tf.COMMON, **case["cfg"])
    jenc = getattr(jatst, case["maker"])(spec_w=W, drop_path_rate=0.0)
    params = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, W)),
                       deterministic=True)["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)
    jtask = jft.FinetuneTask(jenc, jcfg, case["embed"])
    state = jtask.init_state(jax.random.PRNGKey(1), params)
    spec = dict(maker=case["maker"], embed=case["embed"],
                cfg=dict(**tf.COMMON, **case["cfg"], drop_path_rate=0.0))
    task = ft_task(spec)
    start = snapshot(ck.finetune_state_from_flax(state, task))
    key, draws = state.rng, []
    for _ in batches:
        draws.append(tf._jax_draws(key, jcfg))
        key = jax.random.split(key, 3)[0]

    def steps():
        step = jax.jit(jtask.make_train_step())
        jstate = jax.device_put(state, NamedSharding(mesh, P()))
        metrics = []
        for b in batches:
            jstate, m = step(jstate, maybe_shard_batch(
                mesh, {k: jnp.asarray(v) for k, v in b.items()}))
            metrics.append({k: float(v) for k, v in m.items()})
        want, want_mu = tf._flat(jstate)
        return dict(metrics=metrics, params=want, mu=want_mu)

    return dict(spec=spec, state=start, batches=batches, draws=draws), steps


def _sed_inputs(name, jax, jnp, mesh):
    """A SED case of ``test_torch_sed_task.py`` (the DCASE case with the
    head's norm on): the port's state from JAX's, JAX's drop-path
    uniforms (its step traced with ``drop_path`` drawing from known
    keys), and a function that runs JAX's two steps on the mesh."""
    import test_torch_sed_task as ts
    from jax.sharding import NamedSharding, PartitionSpec as P

    from audiossl_tpu.models import transformer as jtr
    from audiossl_tpu.parallel.mesh import maybe_shard_batch
    from audiossl_tpu.sed.head import SEDHead as JHead
    from audiossl_tpu_torch.compat.checkpoint import sed_state_from_flax

    rng = np.random.RandomState(3)
    batches = [ts._batch(rng) for _ in range(2)]
    jtask, jstate, task, state = ts._start(rng, ts.CASES[name])
    # the head's biases moved off their zero init too, as
    # test_torch_finetune.py moves every parameter: a rel L2 against a
    # leaf still near zero after two steps would measure f32 rounding
    jstate = jstate._replace(head_params=jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.randn(*a.shape)).astype(
            np.float32), jstate.head_params))
    task.head.load_state_dict(sed_state_from_flax(jstate.enc_params,
                                                  jstate.head_params)[1])
    use_norm = name == "dcase"
    if use_norm:
        jtask.head = JHead(num_labels=ts.C, use_norm=True)
    spec = dict(cfg=dict(**ts.COMMON, **ts.CASES[name],
                         drop_path_rate=ts.DP_RATE), use_norm=use_norm)
    keys = iter(np.asarray(jax.random.split(jax.random.PRNGKey(9), 64)))
    calls = []
    jax_drop_path = jtr.drop_path

    def drop_path(x, rate, deterministic, key):
        k = next(keys)
        calls.append((k, (x.shape[0],) + (1,) * (x.ndim - 1)))
        return jax_drop_path(x, rate, deterministic, k)

    js = jax.device_put(jstate, NamedSharding(mesh, P()))
    jbatches = [maybe_shard_batch(mesh, {k: jnp.asarray(v)
                                         for k, v in b.items()})
                for b in batches]
    mp = pytest.MonkeyPatch()
    mp.setattr(jtr, "drop_path", drop_path)
    try:  # one trace for both steps: its keys are the steps' uniforms
        lowered = jax.jit(jtask.make_train_step()).lower(js, jbatches[0])
    finally:
        mp.undo()
    u = None
    if name != "freeze":
        u = torch.zeros(2, 2, ts.B)
        for j, (k, shape) in enumerate(calls):
            u[1, j] = torch.from_numpy(np.array(
                jax.random.uniform(k, shape))).reshape(-1)

    def steps():
        step = lowered.compile()
        state, metrics = js, []
        for b in jbatches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        want, want_mu = ts._flat(state)
        return dict(metrics=metrics,
                    params={k: torch.from_numpy(np.array(v))
                            for k, v in want.items()},
                    mu={k: torch.from_numpy(np.array(v))
                        for k, v in want_mu.items()})

    return (dict(spec=spec, state=snapshot(state), batches=batches,
                 draws=[u, u]), steps)


def _port_inputs(name, batch_size, seed):
    """A finetuning case from the port's own state and draws (drop path
    0.5 for the clip case)."""
    import test_torch_finetune as tf

    case = tf.CASES[name]
    rng = np.random.RandomState(seed)
    spec = dict(maker=case["maker"], embed=case["embed"],
                cfg=dict(**tf.COMMON, **case["cfg"],
                         drop_path_rate=0.5 if name == "clip_sgd" else 0.1))
    task = ft_task(spec)
    batches = []
    for _ in range(2):
        b = tf._batch(rng, case)
        batches.append({k: np.concatenate([v] * 2)[:batch_size]
                        for k, v in b.items()})
    gen, npr = torch.Generator().manual_seed(seed), \
        np.random.default_rng(seed)
    draws = [tft.draw_finetune(task.cfg, batch_size,
                               task.rows(batch_size, case["L"]),
                               task.encoder.depth, gen, npr)
             for _ in batches]
    return dict(spec=spec, state=snapshot(task.init_state()),
                batches=batches, draws=draws)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs of every case, the ranks' results, the one-process steps
    and their row-order witnesses, and JAX's steps on a 2-device mesh
    (run while the ranks run)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from audiossl_tpu.parallel import data_mesh

    workdir = str(tmp_path_factory.mktemp("ddp_downstream"))
    mesh = data_mesh(N_RANKS)
    inputs, jax_steps = {}, {}
    for name in FT_CASES:
        inputs[name], jax_steps[name] = _ft_inputs(name, jax, jnp, mesh)
    for name in SED_CASES:
        inputs[name], jax_steps[name] = _sed_inputs(name, jax, jnp, mesh)
    inputs["clip_dp"] = _port_inputs("clip_sgd", 4, 40)
    inputs["ragged"] = _port_inputs("frame_sgd", 3, 41)
    inputs["units"] = unit_inputs()
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))

    failed = []

    def spawn():
        try:
            launch.spawn(ranks_main, N_RANKS, (workdir,), device="cpu",
                         timeout_s=SPAWN_S)
        except BaseException as e:  # raised below, in the fixture
            failed.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jaxes = {name: run() for name, run in jax_steps.items()}
        one, witness = {}, {}
        for case in (*FT_CASES, "clip_dp", *SED_CASES):
            kind = "sed" if case in SED_CASES else "ft"
            inp = inputs[case]
            one[case] = run_case(kind, inp, slice(None))
            half = len(inp["batches"][0]["wav"]) // 2
            swapped = [_swap(b, d, kind, half)
                       for b, d in zip(inp["batches"], inp["draws"])]
            witness[case] = run_case(kind, dict(
                inp, batches=[b for b, _ in swapped],
                draws=[d for _, d in swapped]), slice(None))
        one["ragged"] = run_case("ft", inputs["ragged"], slice(None))
    finally:
        thread.join()
    if failed:
        raise failed[0]
    got = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                      weights_only=False) for r in range(N_RANKS)]
    return dict(inputs=inputs, got=got, one=one, witness=witness,
                jax=jaxes, workdir=workdir)


def _values(s):
    out = {f"encoder.{k}": v for k, v in s["encoder"].items()}
    out.update((f"head.{k}", v) for k, v in s["head"].items())
    return out


@pytest.mark.parametrize("case", (*FT_CASES, "clip_dp", *SED_CASES))
def test_two_rank_steps_match_one_process_on_the_global_batch(ranks, case):
    one, wit = ranks["one"][case], ranks["witness"][case]
    for r, g in enumerate(ranks["got"]):
        g = g[case]
        assert g["step"] == one["step"] == 2
        for m, mo, mw in zip(g["metrics"], one["metrics"], wit["metrics"]):
            assert m["loss"] == pytest.approx(mo["loss"], rel=1e-6), r
            for k in mo:
                floor = abs(mw[k] - mo[k]) / abs(mo[k])
                assert m[k] == pytest.approx(mo[k], rel=max(1e-5, 3 * floor)
                                             ), (r, k, floor)
        bad = []
        for name, a, b, w in (
                ("value", _values(g), _values(one), _values(wit)),
                ("mu", g["mu"], one["mu"], wit["mu"])):
            assert a.keys() == b.keys()
            for k in b:
                if not b[k].is_floating_point():
                    continue
                err, floor = _rel(a[k], b[k]), _rel(w[k], b[k])
                if err >= max(1e-5, 3 * floor):
                    bad.append((name, k, err, floor))
        assert not bad, (r, bad)


@pytest.mark.parametrize("case", (*FT_CASES, *SED_CASES))
def test_two_rank_steps_match_jax_on_a_two_device_mesh(ranks, case):
    want = ranks["jax"][case]
    keys = ("loss", "gnorm") if case in FT_CASES else (
        "loss", "strong_loss", "weak_loss")
    for r, g in enumerate(ranks["got"]):
        g = g[case]
        for m, jm in zip(g["metrics"], want["metrics"]):
            for k in keys:
                assert m[k] == pytest.approx(jm[k], rel=1e-5), (r, k)
        got = _values(g)
        assert set(got) == set(want["params"])
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want["params"][k].numpy(),
                                       rtol=1e-5, atol=2e-5, err_msg=k)
        for k, v in g["mu"].items():
            np.testing.assert_allclose(v.numpy(), want["mu"][k].numpy(),
                                       rtol=1e-5, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("case", (*FT_CASES, "clip_dp", *SED_CASES,
                                  "ragged"))
def test_both_ranks_hold_the_same_state(ranks, case):
    a, b = (g[case] for g in ranks["got"])
    for part in ("encoder", "head", "mu"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert a["metrics"] == b["metrics"]


def test_the_cases_cross_the_ranks(ranks):
    """Mixup's partners cross the ranks, the SED ranks hold different
    sources, and the clip drop path drops sequences on both ranks."""
    inp = ranks["inputs"]
    for case in FT_CASES:
        shift = inp[case]["draws"][0].shift
        partner = (torch.arange(4) - shift) % 4
        assert bool(((partner // 2) != (torch.arange(4) // 2)).any()), case
    source = inp["dcase"]["batches"][0]["source"]
    assert set(source[:4]) == {0} and set(source[4:]) == {1}
    dp = inp["clip_dp"]["draws"][0].dp
    per = dp.shape[-1] // 4
    assert per > 1  # chunks a clip
    for rows in (slice(0, 2 * per), slice(2 * per, 4 * per)):
        assert bool((dp[1:, :, rows] < 0.5).any())


def test_ragged_batch_runs_replicated_as_one_process(ranks):
    """Batches of 3 on 2 ranks: each rank runs them whole with the group's
    reductions off, so the head's BatchNorm running statistics are one
    process's (reduced over the ranks, their unbiased count would be 2x
    too large): loss and running statistics rel 1e-6, the encoder's values
    (all leaves together) rel L2 1e-6; the ranks run on half the
    threads, so the sums differ in their rounding."""
    one = ranks["one"]["ragged"]
    for g in ranks["got"]:
        g = g["ragged"]
        for m, mo in zip(g["metrics"], one["metrics"]):
            assert m["loss"] == pytest.approx(mo["loss"], rel=1e-6)
        for k in ("norm.running_mean", "norm.running_var"):
            assert _rel(g["head"][k], one["head"][k]) < 1e-6, k
        keys = sorted(one["encoder"])
        assert _rel(torch.cat([g["encoder"][k].flatten() for k in keys]),
                    torch.cat([one["encoder"][k].flatten() for k in keys])
                    ) < 1e-6


def test_sed_head_norm_is_global(ranks):
    u = ranks["inputs"]["units"]
    head = SEDHead(16, 3, use_norm=True)
    head.load_state_dict(u["head"])
    x = u["x"].clone().requires_grad_(True)
    strong, weak = head(x)
    ((strong * u["gy"]).sum() + (weak * u["gw"]).sum()).backward()
    for r, g in enumerate(ranks["got"]):
        g, rows = g["units"], slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(g["strong"], strong[rows].detach(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["weak"], weak[rows].detach(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["dx"], x.grad[rows], rtol=1e-5,
                                   atol=1e-6)
        for k, p in head.named_parameters():
            assert _rel(g["dw"][k], p.grad) < 1e-5, k
    # the statistics of a rank's rows alone differ from the global ones
    local = SEDHead(16, 3, use_norm=True)
    local.load_state_dict(u["head"])
    alone = local(u["x"][:2])[0]
    assert _rel(alone.detach(), strong[:2].detach()) > 1e-3


def test_sharded_extraction_with_a_ragged_batch(ranks):
    u = ranks["inputs"]["units"]
    enc = tatst.ast_tiny(spec_w=1001, device="cpu")
    enc.load_state_dict(u["encoder"])
    emb, labels = extract_split(
        make_clip_extractor(enc.eval(), crop_len_s=1.0, n_blocks=2,
                            chunk_len=61), u["loader"])
    assert emb.shape == (7, 2 * 2 * 64)
    for g in ranks["got"]:
        np.testing.assert_allclose(g["units"]["emb"], emb, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(g["units"]["labels"], labels)


def test_keeper_writes_on_rank_zero_and_restores_everywhere(ranks):
    top = os.path.join(ranks["workdir"], "keeper", "top")
    assert sorted(d for d in os.listdir(top) if d.isdigit()) == ["1", "2"]
    a, b = (g["units"] for g in ranks["got"])
    assert a["writes"] and all(w.startswith(top) for w in a["writes"])
    assert b["writes"] == []
    assert torch.equal(a["best"]["w"], torch.full((2,), 1.0))
    assert torch.equal(b["best"]["w"], a["best"]["w"])


def test_local_draws_take_the_clip_major_chunk_rows(monkeypatch):
    """A rank's finetuning draws: its clips' rows, and of the drop-path
    uniforms [depth, 2, B * chunks] the chunks of its clips."""
    task = ft_task(dict(maker="ast_tiny", embed=2 * 2 * 64, cfg=dict(
        crop_len_s=1.5, chunk_len=61, num_labels=5, n_blocks=2,
        specaug=True, rrc=True, mixup_ratio=0.5)))
    d = tft.draw_finetune(task.cfg, 4, task.rows(4, 24000), task.encoder.depth,
                          torch.Generator().manual_seed(2),
                          np.random.default_rng(2))
    per = d.dp.shape[-1] // 4
    assert per == 3
    for rows in (slice(0, 2), slice(2, 4)):
        monkeypatch.setattr(tft, "local_rows", lambda n, _r=rows: _r)
        got = tft.local_draws(d, 4)
        assert torch.equal(got.dp, d.dp[..., rows.start * per:rows.stop * per])
        for a, b in ((got.lam, d.lam), (got.keep, d.keep),
                     *zip(got.freq, d.freq), *zip(got.time, d.time),
                     *zip(got.rrc, d.rrc)):
            assert torch.equal(a, b[rows])
        assert got.shift == d.shift
