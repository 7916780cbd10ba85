"""The SED stack against the JAX package (CPU), on the same numpy inputs.

* ``ManyHotEncoder``: the same events as records to the port and as
  DataFrames to JAX encode to equal grids; decoding equal;
* ``median_filter_1d`` at odd and even windows on random floats, and
  ``decode_preds`` at 1 and 51 thresholds (also decoded in groups of
  thresholds), with the events of ``batched_decode_preds``: equal;
* ``intersection_stats``, ``true_negative_stats``, ``SEDMetrics``,
  ``WeakF1Accumulator``, ``auc_from_curves`` and ``d_prime``: equal;
  ``clip_avg_f1`` and ``f1_from_stats`` within 1e-6 (an f32 mean over the
  batch or the classes, summed in another order);
* ``compute_psds`` in both DCASE scenarios and ``event_based_f1`` on
  seeded random detections with repeated (class, file) groups, unlabelled
  rows and labels the ground truth lacks: within 1e-12 (the sums of
  intersections are taken in another order);
* ``SEDHead`` with JAX's parameters carried across
  (``compat.checkpoint.sed_state_from_flax``), with and without
  ``use_norm`` and ``frame_mask``: rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pd = pytest.importorskip("pandas")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from audiossl_tpu.sed import decode as jdecode  # noqa: E402
from audiossl_tpu.sed import encoder as jencoder  # noqa: E402
from audiossl_tpu.sed import head as jhead  # noqa: E402
from audiossl_tpu.sed import metrics as jmetrics  # noqa: E402
from audiossl_tpu.sed import psds as jpsds  # noqa: E402
from audiossl_tpu_torch.compat.checkpoint import sed_state_from_flax  # noqa: E402
from audiossl_tpu_torch.sed import decode, encoder, head, metrics, psds  # noqa: E402

LABELS = ["Alarm", "Blender", "Cat", "Dog", "Speech"]


def _enc(mod):
    return mod.ManyHotEncoder(LABELS, audio_len=10.0, frame_len=1024,
                              frame_hop=160, net_pooling=4)


def _df(records):
    return pd.DataFrame(records, columns=["event_label", "onset", "offset"])


def test_manyhot_encoder_matches_jax():
    port, ref = _enc(encoder), _enc(jencoder)
    assert port.n_frames == ref.n_frames == 250
    events = [("Cat", 0.0, 1.234), ("Dog", 2.51, 9.999), ("Cat", 5.0, 12.0),
              (None, 1.0, 2.0), ("Speech", 3.3333, 3.3334)]
    want = ref.encode_strong_df(_df(events))
    got = port.encode_strong_df(events)
    np.testing.assert_array_equal(got, want)
    dicts = [dict(zip(("event_label", "onset", "offset"), e)) for e in events]
    np.testing.assert_array_equal(port.encode_strong_df(dicts), want)
    np.testing.assert_array_equal(port.encode_strong_df([]),
                                  ref.encode_strong_df(_df([])))
    np.testing.assert_array_equal(port.encode_strong_df("empty"),
                                  ref.encode_strong_df("empty"))
    weak = ["Dog", "Alarm", ""]
    np.testing.assert_array_equal(port.encode_strong_df(weak),
                                  ref.encode_strong_df(weak))
    for labels in ("Cat,Dog", "empty", ["Speech", "Blender"]):
        np.testing.assert_array_equal(port.encode_weak(labels),
                                      ref.encode_weak(labels))
    np.testing.assert_array_equal(port.encode_weak(events),
                                  ref.encode_weak(_df(events)))
    act = np.random.RandomState(0).rand(250, len(LABELS))
    assert port.decode_strong(act) == ref.decode_strong(act)
    assert port.decode_weak(act[0]) == ref.decode_weak(act[0])


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 8])
def test_median_filter_matches_jax(k):
    x = np.random.RandomState(k).rand(3, 4, 37).astype(np.float32)
    got = decode.median_filter_1d(torch.from_numpy(x), k)
    want = jdecode.median_filter_1d(jnp.asarray(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("n_thds", [1, 51])
def test_decode_preds_matches_jax(monkeypatch, n_thds, grouped):
    if grouped:  # a few thresholds a group
        monkeypatch.setattr(decode, "WINDOW_BYTES", 3 * 4 * 5 * 60 * 7 * 12)
    rng = np.random.RandomState(n_thds)
    scores = rng.rand(4, 5, 60).astype(np.float32)
    thds = (list(np.arange(1 / 100, 1, 1 / 50)) + [0.5] if n_thds > 1
            else [0.5])
    assert len(thds) == n_thds
    got = decode.decode_preds(torch.from_numpy(scores), thds, 7)
    want = jdecode.decode_preds(jnp.asarray(scores), thds, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    names = [f"clip{i}.wav" for i in range(4)]
    got_ev = decode.batched_decode_preds(scores, names, _enc(encoder), thds)
    want_ev = jdecode.batched_decode_preds(scores, names, _enc(jencoder),
                                           thds)
    assert list(got_ev) == list(want_ev)
    n = 0
    for t in thds:
        rows = list(want_ev[t].itertuples(index=False, name=None))
        assert got_ev[t] == rows, t
        n += len(rows)
    assert n > 0


def _binary(rng, shape, p):
    return (rng.rand(*shape) < p).astype(np.float32)


def test_intersection_metrics_match_jax():
    rng = np.random.RandomState(3)
    shape = (6, 4, 50)
    for thd in (0.5, 0.7):
        preds, truths = _binary(rng, shape, 0.4), _binary(rng, shape, 0.3)
        got = metrics.intersection_stats(torch.from_numpy(preds),
                                          torch.from_numpy(truths), thd)
        want = jmetrics.intersection_stats(jnp.asarray(preds),
                                           jnp.asarray(truths), thd)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert float(got[3].sum()) > 0
        np.testing.assert_array_equal(
            metrics.true_negative_stats(torch.from_numpy(1 - preds),
                                        torch.from_numpy(1 - truths)).numpy(),
            np.asarray(jmetrics.true_negative_stats(jnp.asarray(1 - preds),
                                                    jnp.asarray(1 - truths))))
        # the two means: f32 sums over the batch (classes) in another order
        assert float(metrics.clip_avg_f1(
            torch.from_numpy(preds), torch.from_numpy(truths), thd)) == \
            pytest.approx(float(jmetrics.clip_avg_f1(
                jnp.asarray(preds), jnp.asarray(truths), thd)), rel=1e-6)
        tp, fp, fn = (g.sum(0) for g in got[:3])
        assert float(metrics.f1_from_stats(tp, fp, fn)) == pytest.approx(
            float(jmetrics.f1_from_stats(*(jnp.asarray(g.numpy())
                                           for g in (tp, fp, fn)))),
            rel=1e-6)
    # the accumulators over three batches
    port, ref = metrics.SEDMetrics(0.5), jmetrics.SEDMetrics(0.5)
    wport, wref = metrics.WeakF1Accumulator(), jmetrics.WeakF1Accumulator()
    for _ in range(3):
        preds, truths = _binary(rng, shape, 0.4), _binary(rng, shape, 0.3)
        port.accumulate(torch.from_numpy(preds), truths)
        ref.accumulate(preds, truths)
        scores = rng.rand(6, 4).astype(np.float32)
        weak = _binary(rng, (6, 4), 0.5)
        wport.accumulate(scores, weak)
        wref.accumulate(scores, weak)
    np.testing.assert_array_equal(port.tp, ref.tp)
    assert port.macro_f1() == ref.macro_f1()
    assert wport.macro_f1() == wref.macro_f1()
    tpr, fpr = rng.rand(11, 4), rng.rand(11, 4)
    tpr[3, 1] = np.nan
    fpr.sort(axis=0)
    auc = metrics.auc_from_curves(tpr, fpr)
    assert auc == jmetrics.auc_from_curves(tpr, fpr)
    assert metrics.d_prime(0.8) == jmetrics.d_prime(0.8)


CLASSES = ["Alarm", "Blender", "Cat", "Dog"]


def _events(rng, files, n, labels):
    """n random events: (label, onset, offset, filename)."""
    out = []
    for _ in range(n):
        on = float(rng.uniform(0, 9))
        out.append((labels[rng.randint(len(labels))], on,
                    float(min(10.0, on + rng.uniform(0.05, 4))),
                    files[rng.randint(len(files))]))
    return out


def _scoring_inputs():
    """A ground truth with repeated (class, file) groups, operating points
    whose detections follow it loosely, carry unlabelled rows and labels
    the ground truth lacks, and durations."""
    rng = np.random.RandomState(5)
    files = [f"f{i}.wav" for i in range(6)]
    gt = _events(rng, files, 30, CLASSES)
    dets = {}
    for op in np.linspace(0.1, 0.9, 6):
        near = [(lab, max(0.0, on + rng.normal(0, 0.15)),
                 off + rng.normal(0, 0.15), f)
                for lab, on, off, f in gt if rng.rand() > op * 0.7]
        extra = _events(rng, files, 8, CLASSES + ["Zebra"])
        extra.append((None, 1.0, 2.0, files[0]))
        order = rng.permutation(len(near) + len(extra))
        rows = near + extra
        dets[float(op)] = [rows[i] for i in order]
    durations = {"filename": files,
                 "duration": list(rng.uniform(9.5, 10.5, len(files)))}
    return gt, dets, durations


def _jdf(rows):
    return pd.DataFrame(rows, columns=["event_label", "onset", "offset",
                                       "filename"])


@pytest.mark.parametrize("scenario", [1, 2])
def test_compute_psds_matches_jax(scenario):
    gt, dets, durations = _scoring_inputs()
    kw = (dict(dtc_threshold=0.7, gtc_threshold=0.7, alpha_ct=0.0,
               alpha_st=1.0) if scenario == 1 else
          dict(dtc_threshold=0.1, gtc_threshold=0.1, cttc_threshold=0.3,
               alpha_ct=0.5, alpha_st=1.0))
    got = psds.compute_psds(dets, gt, durations, **kw)
    want = jpsds.compute_psds({k: _jdf(v) for k, v in dets.items()},
                              _jdf(gt), pd.DataFrame(durations), **kw)
    assert 0.0 < want <= 1.0
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    # the records as a table and as dicts give the same
    table = {k: psds.event_table(v) for k, v in dets.items()}
    assert psds.compute_psds(table, psds.event_table(gt), durations,
                             **kw) == got


def test_cross_trigger_counts_match_jax():
    """The CTTC counts of one operating point (scenario 2), cell by cell."""
    gt, dets, _ = _scoring_inputs()
    cfg = jpsds.PSDSConfig(0.1, 0.1, 0.3, 0.5, 1.0)
    det = list(dets.values())[2]
    got = psds._per_op_counts(
        psds._select(psds.event_table(det), np.asarray(
            [d[0] is not None for d in det])), psds.event_table(gt),
        CLASSES, psds.PSDSConfig(0.1, 0.1, 0.3, 0.5, 1.0))
    want = jpsds._per_op_counts(_jdf(det).dropna(subset=["event_label"]),
                                _jdf(gt), CLASSES, cfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].sum() > 0 and got[0].sum() > 0


def test_event_based_f1_matches_jax():
    gt, dets, _ = _scoring_inputs()
    for det in dets.values():
        got = psds.event_based_f1(det, gt)
        want = jpsds.event_based_f1(_jdf(det), _jdf(gt))
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    # a greedy match that depends on the detections' order within a group
    gt2 = [("Cat", 1.0, 3.0, "a.wav"), ("Cat", 1.1, 3.1, "a.wav")]
    det2 = [("Cat", 1.05, 3.05, "a.wav"), ("Cat", 1.15, 3.2, "a.wav"),
            ("Dog", 0.0, 1.0, "a.wav")]
    for d in (det2, det2[::-1]):
        assert psds.event_based_f1(d, gt2) == jpsds.event_based_f1(
            _jdf(d), _jdf(gt2))


@pytest.mark.parametrize("use_norm", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sed_head_matches_jax(use_norm, masked):
    rng = np.random.RandomState(7)
    x = rng.randn(3, 25, 32).astype(np.float32)
    mask = (rng.rand(3, 25) > 0.3).astype(np.float32) if masked else None
    ref = jhead.SEDHead(num_labels=6, use_norm=use_norm)
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # move the biases off zero
    params = jax.tree.map(lambda a: np.asarray(a) + (0.05 * rng.randn(
        *a.shape)).astype(np.float32), params)
    want = ref.apply({"params": params}, jnp.asarray(x), 0.8,
                     None if mask is None else jnp.asarray(mask))
    port = head.SEDHead(32, 6, use_norm=use_norm)
    assert {"linear.weight", "linear_softmax.bias"} <= set(port.state_dict())
    port.load_state_dict(sed_state_from_flax({}, params)[1])
    got = port(torch.from_numpy(x), 0.8,
               None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)


def test_sed_head_init_is_seeded():
    a = head.SEDHead(16, 4, generator=torch.Generator().manual_seed(1))
    b = head.SEDHead(16, 4, generator=torch.Generator().manual_seed(1))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert float(a.linear.bias.detach().abs().sum()) == 0.0
    assert abs(float(a.linear.weight.detach().std()) - 0.01) < 0.003
