"""The finetuning slice against the JAX package (CPU).

* ``layer_decay_factors`` equal to JAX's factor for every parameter
  (``ast_tiny`` and ``frame_ast_tiny``, with and without
  ``freeze_embed``);
* ``BatchLoader(weights=...)``'s batches over two epochs and
  ``class_balance_weights`` equal to JAX's (tolerance 0);
* ``TopKKeeper`` with ``k`` 1 and 2, and ``restore_best``;
* ``mixup_spec_label`` with JAX's draws (atol 1e-6);
* the drop-path draws: the share of rows each block drops follows the ramp;
* two finetuning steps from one state bridged by
  ``finetune_state_from_flax`` against JAX's jitted step with its draws,
  drop path 0 on both sides (flax's drop-path keys cannot be handed over;
  ``test_torch_encoder.py`` holds the drop path): clip-tiny (chunked,
  multi-label BCE, mixup, SpecAugment, RandomResizeCrop, ``freeze_embed``)
  and frame-tiny (single-label CE, ``mixup_ratio`` 0.5), both SGD with
  momentum, the one optimizer JAX's driver builds. Loss and gradient norm
  rel 1e-5; every parameter, the momentum trace and the head's BatchNorm
  statistics rtol 1e-5, atol 2e-5, as ``test_torch_clip.py`` holds the
  clip step;
* ``train_finetune.build_task`` makes of the flags the configuration JAX's
  driver makes of them;
* ``python -m audiossl_tpu_torch.downstream.train_finetune ... --device
  cpu`` at tiny width on a synthetic ``audioset_b`` pack writes
  ``result.json``; a frame run at ``--train_len 12`` raises, as JAX's
  encoder does on its 1201 frames; without ``--device`` it raises here.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.datasets.packed import PackedAudioDataset as JPacked  # noqa: E402
from audiossl_tpu.datasets.pipeline import BatchLoader as JLoader  # noqa: E402
from audiossl_tpu.downstream import finetune as jft  # noqa: E402
from audiossl_tpu.methods.distill.train import class_balance_weights as jcbw  # noqa: E402
from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.transforms import target as jtarget  # noqa: E402
from audiossl_tpu_torch import datasets as tds  # noqa: E402
from audiossl_tpu_torch.compat import checkpoint as ck  # noqa: E402
from audiossl_tpu_torch.datasets.packed import PackedAudioDataset  # noqa: E402
from audiossl_tpu_torch.datasets.pipeline import BatchLoader  # noqa: E402
from audiossl_tpu_torch.downstream import finetune as tft  # noqa: E402
from audiossl_tpu_torch.downstream import train_finetune as ttft  # noqa: E402
from audiossl_tpu_torch.methods.distill.train import class_balance_weights  # noqa: E402
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402
from audiossl_tpu_torch.models.transformer import drop_path_multipliers  # noqa: E402
from audiossl_tpu_torch.training.checkpoint import TopKKeeper  # noqa: E402
from audiossl_tpu_torch.transforms import target as ttarget  # noqa: E402

B = 4


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ------------------------------------------------------------------ #
# layer decay, loader, keeper, heads, mixup
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("freeze_embed", [False, True])
@pytest.mark.parametrize("kind", ["clip", "frame"])
def test_layer_decay_factors_match_jax(kind, freeze_embed):
    maker = "ast_tiny" if kind == "clip" else "frame_ast_tiny"
    jenc = getattr(jatst, maker)(spec_w=101)
    port = getattr(tatst, maker)(spec_w=101, device="meta")
    params = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 101)),
                       deterministic=True)["params"]
    want = ck.state_dict_from_flax(jft.layer_decay_factors(
        params, jenc.depth, 0.75, freeze_embed=freeze_embed))
    got = tft.layer_decay_factors([k for k, _ in port.named_parameters()],
                                  port.depth, 0.75, freeze_embed)
    assert set(got) == set(want)
    assert {k: float(v) for k, v in want.items()} == got
    embed = "cls_token" if kind == "clip" else "pos_embed"
    assert got[embed] == (0.0 if freeze_embed else 0.75 ** 2)
    assert got["blocks.1.attn.qkv.weight"] == 0.75


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """A synthetic ``audioset_b`` pack (clips of 1-4 s) and a tiny clip
    and frame encoder as reference-layout ``.ckpt`` files."""
    root = tmp_path_factory.mktemp("finetune")
    data = str(root / "data")
    for split, n, seed in (("train", 16, 1), ("valid", 8, 2),
                           ("test", 8, 3)):
        tds.write_synthetic_pack(data, split, n, min_s=1.0, max_s=4.0,
                                 num_labels=527, multi_label=True,
                                 seed=seed, kind="tones")
    ckpts = {}
    for kind, maker in (("clip", tatst.ast_tiny),
                        ("frame", tatst.frame_ast_tiny)):
        enc = maker(spec_w=1001, device="cpu",
                    generator=torch.Generator().manual_seed(8))
        ckpts[kind] = str(root / f"{kind}.ckpt")
        torch.save({"state_dict": {f"model.teacher.encoder.{k}": v
                                   for k, v in enc.state_dict().items()}},
                   ckpts[kind])
    return root, data, ckpts


def test_weighted_loader_matches_jax(pack):
    """Class-balanced weights, then sampling with replacement per epoch:
    the same records in the same batches as JAX's over two epochs."""
    _, data, _ = pack
    w = class_balance_weights(PackedAudioDataset(data, "train"), 527)
    np.testing.assert_array_equal(w, jcbw(JPacked(data, "train"), 527))
    assert len(np.unique(w)) > 1
    kw = dict(pad_samples=32000, shuffle=True, drop_last=True, weights=w)
    port = BatchLoader(PackedAudioDataset(data, "train"), 4, **kw)
    jax_loader = JLoader(JPacked(data, "train"), 4, num_threads=1, **kw)
    firsts = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == 4
        for g, x in zip(got, want):
            for k in ("wav", "valid", "label"):
                np.testing.assert_array_equal(g[k], x[k])
        firsts.append(got[0]["wav"])
    assert not np.array_equal(*firsts)  # a fresh draw each epoch


@pytest.mark.parametrize("k, kept", [(1, ["1"]), (2, ["1", "2"])])
def test_topk_keeper_keeps_the_best(tmp_path, k, kept):
    keeper = TopKKeeper(str(tmp_path), k=k)
    assert keeper.best_tag is None and keeper.restore_best() is None
    for tag, metric in enumerate([0.3, 0.7, 0.5]):
        keeper.update(metric, tag, {"w": torch.full((2,), float(tag))})
    assert sorted(d for d in os.listdir(keeper.dir) if d.isdigit()) == kept
    assert keeper.best_tag == 1
    assert torch.equal(keeper.restore_best()["w"], torch.full((2,), 1.))
    with open(os.path.join(keeper.dir, "index.json")) as f:
        assert json.load(f)["mode"] == "max"


@pytest.mark.parametrize("alpha", [0.5, 2.0])
def test_mixup_label_matches_jax(alpha):
    rng = np.random.RandomState(10)
    x = rng.randn(5, 8, 12).astype(np.float32)
    label = (rng.rand(5, 7) > 0.6).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want_x, want_y = jtarget.mixup_spec_label(key, jnp.asarray(x),
                                              jnp.asarray(label), alpha=alpha)
    k1, k2 = jax.random.split(key)
    lam = _t(jax.random.beta(k1, alpha, alpha, (5,)))
    shift = int(jax.random.randint(k2, (), 1, 5))
    got_x, got_y = ttarget.mixup_spec_label(_t(x), _t(label), lam, shift)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6)
    lam, shift = ttarget.draw_mixup_label(np.random.default_rng(0),
                                          torch.Generator().manual_seed(0),
                                          5, alpha)
    assert lam.dtype == torch.float32 and 1 <= shift <= 4


def test_drop_path_draws_follow_the_ramp():
    """draw_finetune's uniforms made into keep multipliers: block i of 12
    drops a share 0.1 i / 11 of its rows (within 3 standard errors)."""
    cfg = tft.FinetuneConfig(mixup=False)
    rows = 20000
    d = tft.draw_finetune(cfg, 8, rows, 12, torch.Generator().manual_seed(1),
                          np.random.default_rng(1))
    assert d.dp.shape == (12, 2, rows) and d.lam is None
    dropped = (drop_path_multipliers(d.dp, 0.1) == 0).float().mean(dim=2)
    for i in range(12):
        p = 0.1 * i / 11
        tol = 3 * np.sqrt(max(p * (1 - p), 1e-12) / rows)
        assert abs(dropped[i] - p).max() <= tol, (i, dropped[i])


# ------------------------------------------------------------------ #
# two whole steps
# ------------------------------------------------------------------ #
CASES = {
    "clip_sgd": dict(
        maker="ast_tiny", L=24000, valid=[24000, 20000, 9000, 3000],
        embed=2 * 2 * 64, cfg=dict(
            learning_rate=0.1, crop_len_s=1.5, chunk_len=61,
            multi_label=True, num_labels=5, mixup=True, specaug=True,
            rrc=True, freeze_embed=True)),
    "frame_sgd": dict(
        maker="frame_ast_tiny", L=16000, valid=[16000, 12000, 8000, 4000],
        embed=2 * 64, cfg=dict(
            learning_rate=0.1, crop_len_s=1.0, multi_label=False,
            num_labels=3, mixup=True, mixup_ratio=0.5)),
}
COMMON = dict(max_epochs=2, steps_per_epoch=1, warmup_steps=0, n_blocks=2,
              layer_wise_lr=0.75)


def _jax_draws(rng, cfg):
    """The draws of JAX's step from its state's key (``finetune.py:
    165-204``) and the key the next step starts from."""
    rng, k_aug, _ = jax.random.split(rng, 3)
    k_m, k_l, k_f, k_t, k_r, k_p = jax.random.split(k_aug, 6)
    d = tft.FinetuneDraws()
    if cfg.mixup:
        a = cfg.mixup_alpha
        d.lam = _t(jax.random.beta(k_l, a, a, (B, 1)))[:, 0]
        if cfg.mixup_ratio < 1.0:
            d.keep = _t(jax.random.uniform(k_p, (B, 1)))[:, 0]
        d.shift = int(jax.random.randint(k_m, (), 1, max(B, 2)))
    if cfg.specaug:
        def mask(key, width):
            k1, k2 = jax.random.split(jax.random.split(key, 1)[0])
            return (_t(jax.random.randint(k1, (B, 1), 0, width))[:, 0].long(),
                    _t(jax.random.uniform(k2, (B, 1)))[:, 0])
        d.freq, d.time = mask(k_f, 10), mask(k_t, 50)
    if cfg.rrc:
        h, w, iy, ix = (_t(jax.random.uniform(k, (B,)))
                        for k in jax.random.split(k_r, 4))
        d.rrc = (h, iy, w, ix)
    return d


def _batch(rng, case):
    wav = (rng.randn(B, case["L"]) * 0.1).astype(np.float32)
    valid = np.asarray(case["valid"], np.int32)
    for i, v in enumerate(valid):
        wav[i, v:] = 0.0
    c = case["cfg"]
    if c["multi_label"]:
        label = (rng.rand(B, c["num_labels"]) > 0.5).astype(np.float32)
    else:
        label = rng.randint(c["num_labels"], size=B).astype(np.int32)
    return {"wav": wav, "valid": valid, "label": label}


@pytest.fixture(scope="module", params=sorted(CASES))
def two_steps(request):
    case = CASES[request.param]
    rng = np.random.RandomState(12)
    batches = [_batch(rng, case) for _ in range(2)]
    jcfg = jft.FinetuneConfig(**COMMON, **case["cfg"])
    jenc = getattr(jatst, case["maker"])(spec_w=101, drop_path_rate=0.0)
    params = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 101)),
                       deterministic=True)["params"]
    # move norms and biases off their init values
    params = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)
    jtask = jft.FinetuneTask(jenc, jcfg, case["embed"])
    state = jtask.init_state(jax.random.PRNGKey(1), params)
    step = jax.jit(jtask.make_train_step())
    jax_states, jax_metrics, draws = [state], [], []
    for b in batches:
        draws.append(_jax_draws(jax_states[-1].rng, jcfg))
        s, m = step(jax_states[-1], {k: jnp.asarray(v) for k, v in b.items()})
        jax_states.append(s)
        jax_metrics.append(m)

    pcfg = tft.FinetuneConfig(**COMMON, **case["cfg"], drop_path_rate=0.0)
    task = tft.FinetuneTask(getattr(tatst, case["maker"])(
        spec_w=101, device="cpu"), pcfg, case["embed"])
    pstate = ck.finetune_state_from_flax(state, task)
    before = {k: p.detach().clone() for k, p in pstate.params.items()}
    metrics = [task.train_step(pstate, b, d)[1]
               for b, d in zip(batches, draws)]
    return dict(case=request.param, jcfg=jcfg, jax_states=jax_states,
                jax_metrics=jax_metrics, port=pstate, metrics=metrics,
                before=before, task=task)


def test_step_loss_and_gnorm_match_jax(two_steps):
    for m, jm in zip(two_steps["metrics"], two_steps["jax_metrics"]):
        assert _rel(m["loss"], jm["loss"]) <= 1e-5, (m, jm)
        assert _rel(m["gnorm"], jm["gnorm"]) <= 1e-5, (m, jm)
        # JAX's schedule runs its f32 operations one by one, the port's
        # result is rounded to f32 once: within 2 f32 steps
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=2.5e-7)
    assert two_steps["port"].step == 2


def _flat(state):
    """The JAX state's params and head statistics, and its momentum trace,
    by the port's names."""
    params = {f"encoder.{k}": v for k, v in ck.state_dict_from_flax(
        jax.tree.map(np.asarray, state.enc_params)).items()}
    head = {}
    ck._head_from_flax(jax.tree.map(np.asarray, state.head_params),
                       jax.tree.map(np.asarray, state.head_stats), "head",
                       head)
    params.update(head)
    mu = state.opt_state.trace
    moments = {f"encoder.{k}": v for k, v in ck.state_dict_from_flax(
        jax.tree.map(np.asarray, mu["enc"])).items()}
    ck._head_from_flax(jax.tree.map(np.asarray, mu["head"]), {}, "head",
                       moments)
    return params, moments


def test_step_parameters_match_jax(two_steps):
    want, want_mu = _flat(two_steps["jax_states"][-1])
    port = two_steps["port"]
    got = {f"head.{k}": v for k, v in port.head.state_dict().items()}
    got.update((f"encoder.{k}", v) for k, v in
               port.encoder.state_dict().items())
    assert set(got) == set(want)
    moved = 0
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=k)
        if k in two_steps["before"]:
            moved += not torch.equal(v, two_steps["before"][k])
    assert moved > 10
    if two_steps["case"] == "clip_sgd":
        # freeze_embed: factor 0, so the embeddings keep their values
        # while the blocks move
        for k in ("encoder.pos_embed", "encoder.cls_token",
                  "encoder.patch_embed.patch_embed.weight"):
            assert torch.equal(port.params[k], two_steps["before"][k]), k
    for k, v in port.mu.items():
        np.testing.assert_allclose(v.numpy(), want_mu[k].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=k)


# ------------------------------------------------------------------ #
# the CLI
# ------------------------------------------------------------------ #
def _argv(pack, kind, save, *extra):
    _, data, ckpts = pack
    return ["--pretrained_ckpt_path", ckpts[kind], "--data_path", data,
            "--dataset_name", "audioset_b", "--model_type", kind,
            "--arch", "tiny", "--n_last_blocks", "2", "--batch_size", "4",
            "--max_epochs", "2", "--warmup_epochs", "1", "--save_path",
            save, *extra]


@pytest.mark.parametrize("kind", ["clip", "frame"])
def test_build_task_follows_jax_driver(pack, tmp_path, kind):
    """The task of the flags: JAX's driver's configuration (the learning
    rate scaled by the batch, the warm-up in steps, the recipe's flags),
    field for field where JAX's ``FinetuneConfig`` has the field, and the
    head's input of the last blocks."""
    extra = ["--mask_aug", "--rrc", "--freeze_embed", "--mixup_ratio",
             "0.5", "--alpha", "0.3", "--no-mixup"] if kind == "frame" else []
    args = ttft.build_parser().parse_args(_argv(pack, kind, str(tmp_path),
                                                *extra))
    info = tds.get_dataset(args.dataset_name)
    enc = (tatst.ast_tiny if kind == "clip" else tatst.frame_ast_tiny)(
        spec_w=101, device="cpu")
    task = ttft.build_task(args, info, enc, steps_per_epoch=3)
    want = jft.FinetuneConfig(
        learning_rate=5e-4 * 4 / 256.0, max_epochs=2, steps_per_epoch=3,
        warmup_steps=3, layer_wise_lr=0.75, multi_label=True,
        num_labels=527, n_blocks=2, crop_len_s=12.0,
        mixup=kind == "clip", mixup_alpha=0.3 if kind == "frame" else 0.5,
        mixup_ratio=0.5 if kind == "frame" else 1.0, specaug=kind == "frame",
        rrc=kind == "frame", freeze_embed=kind == "frame")
    got = task.cfg
    for f in dataclasses.fields(got):
        if hasattr(want, f.name) and f.name != "mel":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.max_steps == want.max_steps == 6
    assert task.head.linear.in_features == 64 * 2 * (
        2 if kind == "clip" else 1)


@pytest.mark.parametrize("kind, extra", [
    ("clip", ["--train_len", "2"]),
    ("frame", ["--train_len", "2", "--mask_aug", "--rrc", "--freeze_embed",
               "--mixup_ratio", "0.5"])])
def test_cli_runs_on_cpu(pack, tmp_path, kind, extra):
    record = {}
    res = ttft.main(_argv(pack, kind, str(tmp_path), *extra, "--device",
                          "cpu"), record=record)
    with open(tmp_path / "result.json") as f:
        assert json.load(f) == res
    assert set(res) == {"dataset", "val", "test"}
    for key in ("val", "test"):
        assert np.isfinite(res[key]) and 0.0 <= res[key] <= 1.0
    assert [len(t) for t in record["steps"]] == [4, 4]
    assert [s for s, _ in record["evals"]] == ["valid", "valid", "test"]
    kept = [d for d in os.listdir(tmp_path / "top") if d.isdigit()]
    assert 1 <= len(kept) <= 2


def test_cli_frame_at_12_s_raises_as_jax(pack, tmp_path):
    """JAX's frame encoder (250 position rows at spec_w=1001) cannot take
    the 300 patches of a 12 s crop, and the port's refuses them too; and
    the entry point runs on the card unless asked for the CPU."""
    enc = jatst.frame_ast_tiny(spec_w=1001)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 1001)),
                      deterministic=True)["params"]
    with pytest.raises(TypeError):
        enc.apply({"params": params}, jnp.zeros((2, 64, 1201)),
                  deterministic=True)
    with pytest.raises(ValueError, match="position embeddings"):
        ttft.main(_argv(pack, "frame", str(tmp_path), "--train_len", "12",
                        "--device", "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttft.main(_argv(pack, "clip", str(tmp_path)))
