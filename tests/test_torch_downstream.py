"""The linear probe's modules against the JAX package (CPU, f32).

Tiny encoders (``ast_tiny`` / ``frame_ast_tiny``: width 64, 2 blocks, 2
heads; a 10-block one where the last-8 rule matters) on JAX params moved
off their init and carried over by ``state_dict_from_flax``, seeded numpy
inputs:

* the clip encoder's inference API: ``cls_avg_layers`` (ragged lengths,
  one with no whole patch), ``get_intermediate_layers_chunks`` with T a
  multiple of ``chunk_len`` (an all-padding last chunk), a first chunk
  longer than ``chunk_len`` (its mean divides by more patches than it
  holds, as in JAX) and an empty second chunk, the ``avg=True`` forward,
  ``get_last_selfattention`` and ``pos_type="interpolate"`` at a width
  other than the checkpoint's: atol 2e-4;
* ``resize_bicubic``: atol 1e-5; ``ast_large`` / ``frame_ast_large``
  parameter shapes against ``jax.eval_shape`` of JAX's;
* ``central_crop_frames`` exactly; both extractors and ``extract_split``:
  atol 2e-4;
* the metrics: 1e-6;
* ``train_linear_probe``, multi-label and single-label, on the same
  embeddings with JAX's permutations and initial head handed in: every
  epoch's loss rel 1e-5, the best val and the test metric 1e-4.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from audiossl_tpu.downstream import embedding as jde  # noqa: E402
from audiossl_tpu.downstream import linear as jlin  # noqa: E402
from audiossl_tpu.downstream import metrics as jmet  # noqa: E402
from audiossl_tpu.models import atst as jatst  # noqa: E402
from audiossl_tpu.models.heads import LinearHead as JLinearHead  # noqa: E402
from audiossl_tpu.ops import interpolate as jinterp  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import state_dict_from_flax  # noqa: E402
from audiossl_tpu_torch.downstream import embedding as tde  # noqa: E402
from audiossl_tpu_torch.downstream import linear as tlin  # noqa: E402
from audiossl_tpu_torch.downstream import metrics as tmet  # noqa: E402
from audiossl_tpu_torch.models import atst as tatst  # noqa: E402
from audiossl_tpu_torch.ops.interpolate import resize_bicubic  # noqa: E402

ATOL = 2e-4


def _params(enc, spec_w, seed):
    """Seeded random JAX params of ``enc`` (shapes from
    ``jax.eval_shape``, which compiles nothing): normal(0, 0.05), LayerNorm
    scales about 1."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(functools.partial(enc.init, deterministic=True),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, spec_w)),
                            length=jnp.asarray([spec_w]))["params"]

    def draw(path, a):
        x = (0.05 * rng.randn(*a.shape)).astype(np.float32)
        return x + 1.0 if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(enc, params, *args, method=None, **kw):
    """``enc.apply`` under ``jax.jit`` (an eager flax apply is slow)."""
    fn = functools.partial(enc.apply, method=method, deterministic=True,
                           **kw)
    return np.asarray(jax.jit(fn)({"params": params}, *map(jnp.asarray,
                                                           args)))


def _port(maker, params, **kw):
    enc = maker(device="cpu", **kw)
    enc.load_state_dict(state_dict_from_flax(params))
    return enc.eval()


@pytest.fixture(scope="module")
def clip_tiny():
    enc = jatst.ast_tiny(spec_w=201)
    params = _params(enc, 201, 1)
    return enc, params, _port(tatst.ast_tiny, params, spec_w=201)


@pytest.fixture(scope="module")
def frame_tiny():
    enc = jatst.frame_ast_tiny(spec_w=101)
    params = _params(enc, 101, 2)
    return enc, params, _port(tatst.frame_ast_tiny, params, spec_w=101)


def _mel(B, T, seed):
    return np.random.RandomState(seed).randn(B, 64, T).astype(np.float32)


@pytest.mark.parametrize("kind", ["clip", "frame"])
def test_cls_avg_layers_matches_jax(kind, clip_tiny, frame_tiny):
    enc, params, port = clip_tiny if kind == "clip" else frame_tiny
    T = 201 if kind == "clip" else 101
    mel = _mel(3, T, 3)
    lengths = np.asarray([T, T // 2 + 7, 3], np.int32)  # the last: no patch
    want = jax.jit(functools.partial(
        enc.apply, n=2, deterministic=True, method=enc.cls_avg_layers))(
        {"params": params}, jnp.asarray(mel), jnp.asarray(lengths))
    with torch.no_grad():
        got = port.cls_avg_layers(torch.from_numpy(mel),
                                  torch.from_numpy(lengths), n=2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 3, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert float(got[1][:, 2].abs().max()) == 0.0  # 0 / (0 + 1e-6)


# chunk_len 101 frames: (T, lengths)
CHUNK_CASES = {
    # T = 2 chunk_len: 3 chunks, the last all padding
    "multiple": (202, [202, 150]),
    # the first chunk's length 250 > 101 frames, passed unclamped
    "long_first": (250, [250, 180]),
    # the second clip's second chunk holds no frame (plen 0, mark 0)
    "empty_second": (150, [150, 40]),
}


_JAX_CHUNKS = {}


@pytest.mark.parametrize("avgpool", [True, False])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunks_match_jax(case, avgpool, clip_tiny):
    enc, params, port = clip_tiny
    T, lengths = CHUNK_CASES[case]
    mel = _mel(2, T, 4)
    lengths = np.asarray(lengths, np.int32)
    if case not in _JAX_CHUNKS:  # one compile a case: [cls, means]
        _JAX_CHUNKS[case] = _apply(
            enc, params, mel, lengths, n=2, chunk_len=101, avgpool=True,
            method=enc.get_intermediate_layers_chunks)
    # JAX's avgpool=False returns the first half, the CLS of each block
    want = _JAX_CHUNKS[case][:, :None if avgpool else 2 * 64]
    with torch.no_grad():
        got = port.get_intermediate_layers_chunks(
            torch.from_numpy(mel), torch.from_numpy(lengths), n=2,
            chunk_len=101, avgpool=avgpool).numpy()
    assert got.shape == want.shape == (2, (4 if avgpool else 2) * 64)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_avg_forward_matches_jax():
    """10 blocks: the mean of the raw CLS of blocks 2..9 only."""
    kw = dict(embed_dim=32, depth=10, num_heads=2, spec_w=101, use_cls=True)
    enc = jatst.AudioTransformer(**kw)
    params = _params(enc, 101, 5)
    port = _port(tatst.AudioTransformer, params, **kw)
    mel = _mel(3, 101, 6)
    lengths = np.asarray([101, 60, 3], np.int32)
    want = _apply(enc, params, mel, lengths, avg=True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel), torch.from_numpy(lengths),
                   avg=True).numpy()
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("kind", ["clip", "frame"])
def test_last_selfattention_matches_jax(kind, clip_tiny, frame_tiny):
    enc, params, port = clip_tiny if kind == "clip" else frame_tiny
    mel = _mel(2, 101, 7)
    lengths = np.asarray([101, 41], np.int32)
    fn = functools.partial(enc.apply, method=enc.get_last_selfattention)
    want = np.asarray(jax.jit(fn)({"params": params}, jnp.asarray(mel),
                                  jnp.asarray(lengths)))
    with torch.no_grad():
        got = port.get_last_selfattention(torch.from_numpy(mel),
                                          torch.from_numpy(lengths)).numpy()
    n = 26 if kind == "clip" else 25
    assert got.shape == want.shape == (2, 2, n, n)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.fixture(scope="module", params=["clip", "frame"])
def interpolating(request):
    maker = jatst.ast_tiny if request.param == "clip" else \
        jatst.frame_ast_tiny
    enc = maker(spec_w=201, pos_type="interpolate")
    params = _params(enc, 201, 8)
    return enc, params, _port(getattr(tatst, maker.__name__), params,
                              spec_w=201, pos_type="interpolate")


@pytest.mark.parametrize("T", [101, 301])
def test_interpolated_pos_matches_jax(interpolating, T):
    """Checkpoint width 201 frames (50 patches), inputs of 25 and 75
    patches: the grid resized."""
    enc, params, port = interpolating
    mel = _mel(2, T, 9)
    lengths = np.asarray([T, T // 2], np.int32)
    want = _apply(enc, params, mel, lengths, n=2, scene=False,
                  method=enc.get_intermediate_layers)
    with torch.no_grad():
        got = port.get_intermediate_layers(
            torch.from_numpy(mel), torch.from_numpy(lengths), n=2,
            scene=False).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("out", [(4, 9), (1, 13), (7, 3), (9, 14)])
def test_resize_bicubic_matches_jax(out):
    x = np.random.RandomState(10).randn(2, 3, 5, 7).astype(np.float32)
    resize = jax.jit(functools.partial(
        jinterp.resize_bicubic, out_h=out[0], out_w=out[1],
        align_corners=False))
    want = np.asarray(resize(jnp.asarray(x)))
    got = resize_bicubic(torch.from_numpy(x), *out)
    assert tuple(got.shape) == want.shape == (2, 3) + out
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # torch's own bicubic, the reference's call
    ref = F.interpolate(torch.from_numpy(x), size=out, mode="bicubic",
                        align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def _torch_names(tree, clip):
    """flax param shapes -> {port name: torch shape}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        shape = tuple(leaf.shape)
        if keys[-1] == "kernel":
            keys[-1], shape = "weight", shape[::-1]
        elif keys[-1] == "scale":
            keys[-1] = "weight"
        if keys[0] == "patch_proj":
            keys[0] = "patch_embed.patch_embed"
        elif keys[0] == "norm" and not clip:
            keys[0] = "norm_frame"
        elif keys[0].startswith("blocks_"):
            keys[0] = "blocks." + keys[0][len("blocks_"):]
        out[".".join(keys)] = shape
    return out


@pytest.mark.parametrize("name", ["ast_large", "frame_ast_large"])
def test_large_param_shapes_match_jax(name):
    enc = getattr(jatst, name)(spec_w=1001)
    shapes = jax.eval_shape(
        lambda: enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 1001)),
                         length=jnp.asarray([1001]),
                         deterministic=True))["params"]
    want = _torch_names(shapes, clip=name == "ast_large")
    port = getattr(tatst, name)(spec_w=1001, device="meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert (port.embed_dim, port.depth, port.num_heads) == (1024, 24, 16)


def test_central_crop_matches_jax():
    rng = np.random.RandomState(11)
    L, crop = 3000, 2000
    wav = rng.randn(4, L).astype(np.float32)
    valid = np.asarray([3000, 2500, 1200, 2001], np.int32)
    for c in (crop, 4000):  # a crop wider than the batch keeps L
        w_out, w_valid = jde.central_crop_frames(jnp.asarray(wav),
                                                 jnp.asarray(valid), c)
        g_out, g_valid = tde.central_crop_frames(
            torch.from_numpy(wav), torch.from_numpy(valid).long(), c)
        np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))
        np.testing.assert_array_equal(g_valid.numpy(), np.asarray(w_valid))


class _Loader:
    """Fixed batches of 2 padded clips of 1-2.5 s."""

    def __init__(self, seed, n=4):
        rng = np.random.RandomState(seed)
        pad = 40000
        self.wav = np.zeros((n, pad), np.float32)
        self.valid = np.asarray([40000, 24000, 16000, 32000][:n], np.int32)
        for i, v in enumerate(self.valid):
            t = np.arange(v) / 16000.0
            self.wav[i, :v] = (0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t)
                               + 0.05 * rng.randn(v))
        self.label = np.arange(n)

    def __iter__(self):
        for i in range(0, len(self.wav), 2):
            yield {"wav": self.wav[i:i + 2], "valid": self.valid[i:i + 2],
                   "label": self.label[i:i + 2]}


@pytest.mark.parametrize("kind", ["clip", "frame"])
def test_extractors_match_jax(kind, clip_tiny, frame_tiny):
    """2.5 s crops (251 frames): the clip extractor cuts 3 chunks of 101
    frames (the first unclamped), the frame one 2 (the 49-frame tail
    dropped; the 1.5 s clip's second chunk of 50 frames unmarked)."""
    enc, params, port = clip_tiny if kind == "clip" else frame_tiny
    if kind == "clip":
        jx = jde.make_clip_extractor(enc, params, crop_len_s=2.5, n_blocks=2,
                                     chunk_len=101)
        tx = tde.make_clip_extractor(port, crop_len_s=2.5, n_blocks=2,
                                     chunk_len=101)
    else:
        jx = jde.make_frame_extractor(enc, params, crop_len_s=2.5,
                                      n_blocks=2, chunk_len_s=1.0)
        tx = tde.make_frame_extractor(port, crop_len_s=2.5, n_blocks=2,
                                      chunk_len_s=1.0)
    loader = _Loader(12)
    want_e, want_y = jde.extract_split(jx, loader)
    times = []
    got_e, got_y = tde.extract_split(tx, loader, times)
    assert got_e.shape == want_e.shape == (4, (4 if kind == "clip" else 2)
                                           * 64)
    np.testing.assert_allclose(got_e, want_e, atol=ATOL)
    np.testing.assert_array_equal(got_y, want_y)
    assert [n for n, _ in times] == [2, 2]


def test_metrics_match_jax():
    rng = np.random.RandomState(13)
    scores = rng.rand(40, 6).astype(np.float32)
    targets = (rng.rand(40, 6) < 0.3).astype(np.float32)
    targets[:, 4] = 0.0  # a class with no positive: NaN, dropped
    assert np.isnan(tmet.average_precision(scores[:, 4], targets[:, 4]))
    for c in range(6):
        a = tmet.average_precision(scores[:, c], targets[:, c])
        b = jmet.average_precision(scores[:, c], targets[:, c])
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-6
    for mode, (p, t) in (("mAP", (scores, targets)),
                         ("ACC", (scores, rng.randint(6, size=40)))):
        mt, mj = tmet.Metric(mode), jmet.Metric(mode)
        for sl in (slice(0, 17), slice(17, 40)):
            mt.update(p[sl], t[sl])
            mj.update(p[sl], t[sl])
        assert abs(mt.compute() - mj.compute()) <= 1e-6


def _probe_data(multi, seed):
    """Embeddings [n, 48] that carry their labels, for 3 splits."""
    rng = np.random.RandomState(seed)
    C = 12 if multi else 5
    centers = rng.randn(C, 48).astype(np.float32)
    out = []
    for n in (96, 40, 40):
        if multi:
            y = (rng.rand(n, C) < 0.25).astype(np.float32)
            x = y @ centers + rng.randn(n, 48).astype(np.float32)
        else:
            y = rng.randint(C, size=n)
            x = centers[y] + 1.5 * rng.randn(n, 48).astype(np.float32)
        out += [x.astype(np.float32), y]
    return out


def _jax_draws(cfg, n, dim, num_labels):
    """JAX's initial head and epoch permutations, as its probe draws them."""
    rng = jax.random.PRNGKey(cfg.seed)
    v = JLinearHead(num_labels=num_labels).init(
        rng, jnp.zeros((2, dim)), train=True)
    head = {
        "norm.running_mean": torch.tensor(np.array(
            v["batch_stats"]["norm"]["mean"])),
        "norm.running_var": torch.tensor(np.array(
            v["batch_stats"]["norm"]["var"])),
        "linear.weight": torch.tensor(np.array(
            v["params"]["linear"]["kernel"]).T),
        "linear.bias": torch.tensor(np.array(v["params"]["linear"]["bias"])),
    }
    perms, key = [], rng
    for _ in range(cfg.max_epochs):
        key, sk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sk, n)))
    return tlin.ProbeDraws(perms=perms, head=head)


@pytest.mark.parametrize("multi", [True, False])
def test_linear_probe_matches_jax(multi):
    data = _probe_data(multi, 14 if multi else 15)
    kw = dict(learning_rate=0.05, batch_size=32, max_epochs=8,
              multi_label=multi, num_labels=12 if multi else 5,
              lr_scale=32 / 256.0, seed=3)
    want = jlin.train_linear_probe(*data, jlin.LinearProbeConfig(**kw))
    cfg = tlin.LinearProbeConfig(**kw)
    got = tlin.train_linear_probe(
        *data, cfg, device="cpu",
        draws=_jax_draws(cfg, len(data[0]), 48, kw["num_labels"]))
    assert len(got["train_losses"]) == 8
    np.testing.assert_allclose(got["train_losses"], want["train_losses"],
                               rtol=1e-5)
    assert abs(got["val_metric"] - want["val_metric"]) <= 1e-4
    assert abs(got["test_metric"] - want["test_metric"]) <= 1e-4
    # the probe learned: above chance
    assert got["val_metric"] > (0.5 if multi else 0.4)
    np.testing.assert_allclose(
        got["state"]["linear.weight"].numpy(),
        np.asarray(want["params"]["linear"]["kernel"]).T, atol=1e-5)


def test_linear_probe_draws_from_seed():
    """Without draws: a fixed seed repeats, another seed differs."""
    data = _probe_data(False, 16)
    runs = [tlin.train_linear_probe(
        *data, tlin.LinearProbeConfig(learning_rate=0.05, batch_size=32,
                                      max_epochs=3, seed=s), device="cpu")
        for s in (0, 0, 1)]
    assert runs[0]["train_losses"] == runs[1]["train_losses"]
    assert runs[0]["train_losses"] != runs[2]["train_losses"]
    assert np.isfinite(runs[0]["test_metric"])
