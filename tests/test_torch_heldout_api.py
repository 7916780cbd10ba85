"""The JAX API the port kept out until now, against the JAX package (CPU).

* ``models.heads.AttentionHead`` loaded by
  ``compat.checkpoint.attention_head_state_from_torch`` from a reference
  state dict (every key placed) against JAX's ``AttentionHead`` on
  ``attention_head_from_torch``'s params: outputs in training and eval
  mode rel L2 <= 1e-5, every parameter's gradient rel L2 <= 1e-4 (in
  training mode the biases the BatchNorm cancels to a vanishing norm);
* a frame encoder with ``nprompt=2`` on JAX's params through
  ``state_dict_from_flax``: the pretraining forward's frames and
  selection, ``get_intermediate_layers`` with the prompt means and the
  frame sequences (atol 2e-5), and the bridge back through JAX's
  ``encoder_params_from_torch`` bit-equal; the prompt embedding takes the
  embeddings' layer-decay factor;
* one finetuning step with ``optimizer="adamw", weight_decay=0.05`` (and
  layer decay) from one state against JAX's jitted step: loss rel 1e-5,
  both Adam moments and every parameter rtol 1e-5, atol 2e-5 (but the
  few elements whose gradient is below Adam's epsilon, at its rounding
  floor, whose first update turns on that rounding: within the step's
  reach);
* ``mixup_wav_label`` with JAX's draws handed in (atol 1e-6);
* the SED sets' ``return_filename=False`` items and
  ``MixedBatchLoader(epoch=)``'s batches equal to JAX's;
* ``SEDConfig``'s fields and defaults are JAX's, and its
  ``n_test_thresholds`` and ``audio_len`` reach the test's PSDS as JAX's
  driver reads them.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pd = pytest.importorskip("pandas")
import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.compat.torch_import import (  # noqa: E402
    attention_head_from_torch, encoder_params_from_torch)
from audiossl_tpu.datasets import sed as jsed  # noqa: E402
from audiossl_tpu.downstream import finetune as jft  # noqa: E402
from audiossl_tpu.downstream import train_dcase as jdcase  # noqa: E402
from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models.heads import AttentionHead as JAttentionHead  # noqa: E402
from audiossl_tpu.sed.module import SEDConfig as JSEDConfig  # noqa: E402
from audiossl_tpu.transforms import target as jtarget  # noqa: E402
from audiossl_tpu_torch.compat import checkpoint as ck  # noqa: E402
from audiossl_tpu_torch.datasets import sed  # noqa: E402
from audiossl_tpu_torch.downstream import finetune as tft  # noqa: E402
from audiossl_tpu_torch.downstream import train_dcase as tdcase  # noqa: E402
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402
from audiossl_tpu_torch.models.heads import AttentionHead  # noqa: E402
from audiossl_tpu_torch.sed.module import SEDConfig  # noqa: E402
from audiossl_tpu_torch.transforms import target as ttarget  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ #
# AttentionHead
# ------------------------------------------------------------------ #
IN, ATT, HEADS, LABELS = 24, 32, 4, 5


def _reference_head_sd(rng):
    """A reference ``AttentionHead`` state dict (torch layout) with every
    parameter off its init value, and a key JAX's importer skips."""
    def r(*s, scale=0.1):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))

    sd = {"pre_linear.weight": r(ATT, IN), "pre_linear.bias": r(ATT),
          "cls_token": r(1, 1, ATT, scale=0.02),
          "linear.weight": r(LABELS, ATT), "linear.bias": r(LABELS),
          "norm.running_mean": r(ATT),
          "norm.running_var": torch.from_numpy(
              (1.0 + rng.rand(ATT)).astype(np.float32)),
          "norm.num_batches_tracked": torch.tensor(3)}
    for n in ("norm1", "norm2"):
        sd[f"att.{n}.weight"] = 1.0 + r(ATT)
        sd[f"att.{n}.bias"] = r(ATT)
    sd["att.attn.qkv.weight"] = r(3 * ATT, ATT)
    sd["att.attn.proj.weight"] = r(ATT, ATT)
    sd["att.attn.proj.bias"] = r(ATT)
    sd["att.mlp.fc1.weight"] = r(4 * ATT, ATT)
    sd["att.mlp.fc1.bias"] = r(4 * ATT)
    sd["att.mlp.fc2.weight"] = r(ATT, 4 * ATT)
    sd["att.mlp.fc2.bias"] = r(ATT)
    return sd


def _head_grads_by_port_name(g):
    """JAX's AttentionHead gradient tree -> the port's parameter names
    (torch layout)."""
    out = {"pre_linear.weight": g["pre_linear"]["kernel"].T,
           "pre_linear.bias": g["pre_linear"]["bias"],
           "cls_token": g["cls_token"],
           "linear.weight": g["linear"]["kernel"].T,
           "linear.bias": g["linear"]["bias"]}
    blk = {}
    ck._block(jax.tree.map(np.asarray, g["att"]), "att", blk)
    out.update({k: v.numpy() for k, v in blk.items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("train", [True, False])
def test_attention_head_matches_jax(train):
    rng = np.random.RandomState(0)
    sd = _reference_head_sd(rng)
    head = AttentionHead(IN, ATT, HEADS, LABELS, device="cpu")
    mapped = ck.attention_head_state_from_torch(sd)
    assert set(mapped) == set(head.state_dict())  # every key placed
    head.load_state_dict(mapped)
    head.train(train)
    params, stats = attention_head_from_torch(sd)
    jhead = JAttentionHead(att_dim=ATT, num_heads=HEADS, num_labels=LABELS)
    x = rng.randn(6, 7, IN).astype(np.float32)
    w = rng.randn(6, LABELS).astype(np.float32)

    def jloss(p):
        out = jhead.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                          train=train, mutable=["batch_stats"])[0]
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    out = head(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    assert _rel(out.detach().numpy(), np.asarray(jout)) <= 1e-5
    want = _head_grads_by_port_name(jgrad)
    got = {k: p.grad.numpy() for k, p in head.named_parameters()}
    assert set(got) == set(want)
    # in training mode the BatchNorm's batch mean cancels every constant
    # shift of the CLS row (the biases added to it), so both frameworks
    # hold rounding noise there: such a leaf is held to a vanishing norm
    top = max(np.linalg.norm(v) for v in want.values())
    for k in want:
        if np.linalg.norm(want[k]) < 1e-6 * top:
            assert np.linalg.norm(got[k]) <= 1e-6 * top, k
        else:
            assert _rel(got[k], want[k]) <= 1e-4, k


# ------------------------------------------------------------------ #
# the encoder's prompt tokens
# ------------------------------------------------------------------ #
SPEC_W, NPROMPT = 201, 2
LENGTHS = np.asarray([201, 122, 45], np.int32)


@pytest.fixture(scope="module")
def prompt_encoder():
    rng = np.random.RandomState(1)
    jenc = jatst.AudioTransformer(embed_dim=64, depth=2, num_heads=2,
                                  spec_w=SPEC_W, use_cls=False,
                                  nprompt=NPROMPT)
    mel = rng.randn(3, 64, SPEC_W).astype(np.float32)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(mel),
                       length=jnp.asarray(LENGTHS),
                       deterministic=True)["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)
    enc = tatst.AudioTransformer(embed_dim=64, depth=2, num_heads=2,
                                 spec_w=SPEC_W, use_cls=False,
                                 nprompt=NPROMPT, device="cpu")
    enc.load_state_dict(ck.state_dict_from_flax(params))
    return jenc, params, enc.eval(), mel


def test_prompt_forward_matches_jax(prompt_encoder):
    jenc, params, enc, mel = prompt_encoder
    mask = np.random.RandomState(2).rand(3, 50) < 0.5
    jf, jsel = jenc.apply({"params": params}, jnp.asarray(mel),
                          jnp.asarray(LENGTHS), mask_index=jnp.asarray(mask),
                          apply_mask=True, deterministic=True)
    with torch.no_grad():
        f, sel = enc(torch.from_numpy(mel), torch.from_numpy(LENGTHS),
                     mask_index=torch.from_numpy(mask), apply_mask=True)
    assert f.shape == (3, 50, 64)  # the prompt rows dropped
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    valid = np.arange(50)[None] < (LENGTHS // 4)[:, None]
    np.testing.assert_allclose(f.numpy()[valid], np.asarray(jf)[valid],
                               atol=2e-5)


@pytest.mark.parametrize("scene", [True, False])
def test_prompt_intermediate_layers_match_jax(prompt_encoder, scene):
    jenc, params, enc, mel = prompt_encoder
    want = np.asarray(jenc.apply(
        {"params": params}, jnp.asarray(mel), jnp.asarray(LENGTHS), n=2,
        scene=scene, method=jenc.get_intermediate_layers))
    with torch.no_grad():
        got = enc.get_intermediate_layers(
            torch.from_numpy(mel), torch.from_numpy(LENGTHS), n=2,
            scene=scene).numpy()
    # scene: each block's token mean, then its prompt tokens' mean
    assert got.shape == ((3, 4 * 64) if scene else (3, 50, 2 * 64))
    if not scene:  # the valid tokens (JAX's padding tokens attend alike)
        valid = np.arange(50)[None] < (LENGTHS // 4)[:, None]
        got, want = got[valid], want[valid]
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_prompt_bridge_both_ways(prompt_encoder):
    _, params, enc, _ = prompt_encoder
    back = encoder_params_from_torch(
        {k: v.numpy() for k, v in enc.state_dict().items()})
    flat = jax.tree_util.tree_leaves_with_path
    got = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat(back)}
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat(params)}
    assert set(got) == set(want) and "['prompt_embed']" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    factors = tft.layer_decay_factors(
        [k for k, _ in enc.named_parameters()], 2, 0.75)
    assert factors["prompt_embed"] == factors["pos_embed"] == 0.75 ** 2


# ------------------------------------------------------------------ #
# finetuning with AdamW and weight decay
# ------------------------------------------------------------------ #
FT = dict(max_epochs=2, steps_per_epoch=1, warmup_steps=0, n_blocks=2,
          layer_wise_lr=0.75, learning_rate=1e-3, crop_len_s=1.0,
          multi_label=False, num_labels=3, mixup=False,
          optimizer="adamw", weight_decay=0.05)


def _moments(tree):
    out = {f"encoder.{k}": v for k, v in ck.state_dict_from_flax(
        jax.tree.map(np.asarray, tree["enc"])).items()}
    ck._head_from_flax(jax.tree.map(np.asarray, tree["head"]), {}, "head",
                       out)
    return out


def test_adamw_finetune_step_matches_jax():
    rng = np.random.RandomState(3)
    B = 4
    wav = (rng.randn(B, 16000) * 0.1).astype(np.float32)
    batch = {"wav": wav, "valid": np.asarray([16000, 12000, 8000, 4000],
                                             np.int32),
             "label": rng.randint(3, size=B).astype(np.int32)}
    jcfg = jft.FinetuneConfig(**FT)
    jenc = jatst.frame_ast_tiny(spec_w=101, drop_path_rate=0.0)
    params = jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 101)),
                       deterministic=True)["params"]
    params = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)
    jtask = jft.FinetuneTask(jenc, jcfg, 2 * 64)
    state = jtask.init_state(jax.random.PRNGKey(1), params)
    jstate, jm = jax.jit(jtask.make_train_step())(
        state, {k: jnp.asarray(v) for k, v in batch.items()})

    task = tft.FinetuneTask(tatst.frame_ast_tiny(spec_w=101, device="cpu"),
                            tft.FinetuneConfig(**FT, drop_path_rate=0.0),
                            2 * 64)
    pstate = ck.finetune_state_from_flax(state, task)
    assert pstate.count == 0 and pstate.nu is not None
    pstate, m = task.train_step(pstate, batch, tft.FinetuneDraws())
    assert _rel(m["loss"], jm["loss"]) <= 1e-5
    assert pstate.count == int(jstate.opt_state.count) == 1
    want = {f"encoder.{k}": v for k, v in ck.state_dict_from_flax(
        jax.tree.map(np.asarray, jstate.enc_params)).items()}
    ck._head_from_flax(jax.tree.map(np.asarray, jstate.head_params),
                       jax.tree.map(np.asarray, jstate.head_stats), "head",
                       want)
    got = {f"encoder.{k}": v for k, v in pstate.encoder.state_dict().items()}
    got.update((f"head.{k}", v) for k, v in pstate.head.state_dict().items())
    assert set(got) == set(want)
    # Adam's first update is g / (|g| + 1e-6) elementwise: where |g| is
    # below that epsilon it sits at the gradient's rounding floor (the two
    # frameworks' sums give 1e-7 against 2e-8 there), which moves the
    # update by O(1), so those few elements are held to the step's reach
    # (lr times at most 1 + wd |p|), every other at the tight tolerance
    g_mu = _moments(jstate.opt_state.mu)
    loose = 0
    for k in want:
        a, b = got[k].numpy(), want[k].numpy()
        if k.startswith("head.norm."):  # BatchNorm statistics
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-5, err_msg=k)
            continue
        near = np.abs(10.0 * g_mu[k].numpy()) < 1e-6
        loose += int(near.sum())
        np.testing.assert_allclose(a[~near], b[~near], rtol=1e-5, atol=2e-5,
                                   err_msg=k)
        assert np.all(np.abs(a - b)[near] <= 2 * FT["learning_rate"]), k
    assert loose < 2e-2 * sum(v.numel() for v in got.values()), loose
    for mine, theirs in ((pstate.mu, jstate.opt_state.mu),
                         (pstate.nu, jstate.opt_state.nu)):
        theirs = _moments(theirs)
        for k in theirs:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(),
                                       rtol=1e-5, atol=2e-5, err_msg=k)


# ------------------------------------------------------------------ #
# mixup_wav_label
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("alpha", [0.5, 10.0])
def test_mixup_wav_label_matches_jax(alpha):
    rng = np.random.RandomState(4)
    wav = rng.randn(5, 300).astype(np.float32)
    label = (rng.rand(5, 7) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jw, jy = jtarget.mixup_wav_label(key, jnp.asarray(wav),
                                     jnp.asarray(label), alpha)
    k1, k2 = jax.random.split(key)
    lam = torch.from_numpy(np.array(jax.random.beta(k1, alpha, alpha, (5,))))
    shift = int(jax.random.randint(k2, (), 1, 5))
    w, y = ttarget.mixup_wav_label(torch.from_numpy(wav),
                                   torch.from_numpy(label), lam, shift)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)


# ------------------------------------------------------------------ #
# the SED sets and loader, SEDConfig
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def dcase(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("heldout_sed") / "dcase")
    sed.write_synthetic_sed(
        path, {"synth_train": 5, "weak_train": 6, "synth_val": 3,
               "strong_val": 4}, sed.DCASE_CLASSES,
        weak_splits=("weak_train",), seed=6, seconds=1.0)
    return path


def _sets(path, return_filename):
    """The strong and weak training sets and the unlabeled set of both
    packages, built with ``return_filename``."""
    enc, jenc = sed.dcase_encoder(), jsed.dcase_encoder()
    out = []
    for split, kind in (("synth_train", "strong"), ("weak_train", "weak")):
        audio = os.path.join(path, split, "audio")
        tsv = os.path.join(path, split, "meta.tsv")
        cls, jcls = ((sed.StronglyAnnotatedSet, jsed.StronglyAnnotatedSet)
                     if kind == "strong" else (sed.WeakSet, jsed.WeakSet))
        out.append((cls(audio, sed.read_tsv(tsv), enc,
                        return_filename=return_filename),
                    jcls(audio, pd.read_csv(tsv, sep="\t"), jenc,
                         return_filename=return_filename)))
    audio = os.path.join(path, "synth_val", "audio")
    out.append((sed.UnlabeledSet(audio, enc, return_filename=return_filename),
                jsed.UnlabeledSet(audio, jenc,
                                  return_filename=return_filename)))
    return out


@pytest.mark.parametrize("return_filename", [False, True])
def test_return_filename_items_match_jax(dcase, return_filename):
    for port, ref in _sets(dcase, return_filename):
        assert len(port) == len(ref) > 0
        for i in range(len(ref)):
            got, want = port[i], ref[i]
            assert len(got) == len(want) == (3 if return_filename else 2)
            for g, w in zip(got, want):
                if isinstance(w, str):
                    assert g == w
                else:
                    np.testing.assert_array_equal(g, w)


def test_mixed_batch_loader_epoch_matches_jax(dcase):
    sets = _sets(dcase, False)[:2]
    got = list(sed.MixedBatchLoader([p for p, _ in sets], [2, 2], seed=1,
                                    epoch=3))
    want = list(jsed.MixedBatchLoader([j for _, j in sets], [2, 2], seed=1,
                                      epoch=3))
    later = sed.MixedBatchLoader([p for p, _ in sets], [2, 2], seed=1)
    later.set_epoch(3)
    assert len(got) == len(want) > 1
    for g, w, s in zip(got, want, later):
        for k in ("wav", "valid", "strong", "source"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(g[k], s[k], err_msg=k)
        assert g["filenames"] == w["filenames"] == [""] * 4
    first = next(iter(sed.MixedBatchLoader([p for p, _ in sets], [2, 2],
                                           seed=1)))
    assert not np.array_equal(first["wav"], got[0]["wav"])


def test_sed_config_fields_are_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JSEDConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(SEDConfig)}
    assert set(pf) - set(jf) == {"drop_path_rate"}  # the port's own
    for k, v in jf.items():
        if k == "mel":
            assert dataclasses.asdict(pf[k]) == dataclasses.asdict(v)
        else:
            assert pf[k] == v, k
    cfg = SEDConfig(audio_len=2.5, sr=8000)
    assert cfg.n_samples == JSEDConfig(audio_len=2.5, sr=8000).n_samples


def test_sed_config_reaches_the_test_metrics(dcase):
    """``n_test_thresholds`` sets the PSDS operating points and
    ``audio_len`` the durations of a split without ``durations.tsv``, as
    in JAX's ``train_dcase`` (``train_dcase.py:58-59, 264-269``)."""
    cfg = SEDConfig(n_test_thresholds=7, audio_len=1.0)
    jcfg = JSEDConfig(n_test_thresholds=7, audio_len=1.0)
    split = os.path.join(dcase, "synth_val")
    gt, durations = tdcase.read_ground_truth(split, cfg.audio_len)
    jgt = pd.read_csv(os.path.join(split, "meta.tsv"), sep="\t")
    jdur = pd.DataFrame({"filename": jgt.filename.unique(),
                         "duration": [jcfg.audio_len]
                         * jgt.filename.nunique()})
    assert list(durations["filename"]) == list(jdur.filename)
    assert durations["duration"] == list(jdur.duration) == [1.0] * len(jdur)
    port = sed.load_dcase_split(os.path.join(split, "audio"),
                                os.path.join(split, "meta.tsv"), "strong")
    ref = jsed.StronglyAnnotatedSet(os.path.join(split, "audio"), jgt,
                                    jsed.dcase_encoder())
    C = len(sed.DCASE_CLASSES)

    def stub(batch):  # fixed scores from each batch's waveforms
        w = np.asarray(batch["wav"])[:, :C * 62].reshape(-1, C, 62)
        return 1.0 / (1.0 + np.exp(-40.0 * w)), None

    got = tdcase.evaluate_test(
        None, lambda s, b: (torch.from_numpy(stub(b)[0]), None), None,
        sed.MixedBatchLoader([port], [3], shuffle=False),
        sed.dcase_encoder(), cfg, gt, durations)
    want = jdcase.evaluate_test(
        None, lambda s, b: stub(b), None,
        jsed.MixedBatchLoader([ref], [3], shuffle=False),
        jsed.dcase_encoder(), jcfg, jgt, jdur)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    # another threshold count moves PSDS as it moves JAX's
    other = tdcase.evaluate_test(
        None, lambda s, b: (torch.from_numpy(stub(b)[0]), None), None,
        sed.MixedBatchLoader([port], [3], shuffle=False),
        sed.dcase_encoder(), SEDConfig(n_test_thresholds=3, audio_len=1.0),
        gt, durations)
    jother = jdcase.evaluate_test(
        None, lambda s, b: stub(b), None,
        jsed.MixedBatchLoader([ref], [3], shuffle=False),
        jsed.dcase_encoder(), JSEDConfig(n_test_thresholds=3, audio_len=1.0),
        jgt, jdur)
    assert other["psds1"] == pytest.approx(jother["psds1"], rel=1e-12,
                                           abs=1e-12)
