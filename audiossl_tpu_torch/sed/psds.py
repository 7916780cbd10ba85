"""Polyphonic Sound Detection Score (PSDS) and collar-based event F1 (the
port's own copy of ``audiossl_tpu/sed/psds.py``, with numpy in place of
pandas): host-side test-time scoring, from the PSDS definition (Bilen et
al., ICASSP 2020):

* DTC: a detection is valid iff its summed intersection with same-class
  ground truths covers >= dtc_threshold of its duration;
* GTC: a ground truth counts as TP iff DTC-valid detections cover
  >= gtc_threshold of its duration;
* CTTC: invalid detections count as cross-triggers against other
  classes' ground truths when covered >= cttc_threshold;
* per operating point and class: eTPR = TP / #GT, eFPR = #FP per hour,
  the cross-trigger rate folded in with alpha_ct; the PSD-ROC takes the
  running max TPR over operating points sorted by eFPR, the effective TPR
  subtracts alpha_st * std across classes, and PSDS is the normalized
  area under the curve up to e_max FP per hour.

DCASE scenario 1: dtc = gtc = 0.7, alpha_ct = 0, alpha_st = 1.
DCASE scenario 2: dtc = gtc = 0.1, cttc = 0.3, alpha_ct = 0.5, alpha_st = 1.

Events are tables: a dict of numpy arrays ``event_label`` (objects; None
for a row without an event), ``onset``, ``offset`` and ``filename``
(:func:`event_table` makes one of event records ``(event_label, onset,
offset, filename)``); durations a table of ``filename`` and ``duration``.
The JAX package's pandas merges and groupbys become sorted keys and
``bincount`` sums in the same row order, so the counts are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np

from audiossl_tpu_torch.sed.encoder import is_label

COLUMNS = ("event_label", "onset", "offset", "filename")


@dataclasses.dataclass
class PSDSConfig:
    dtc_threshold: float = 0.5
    gtc_threshold: float = 0.5
    cttc_threshold: float = 0.3
    alpha_ct: float = 0.0
    alpha_st: float = 0.0
    e_max: float = 100.0  # FP per hour


def event_table(events) -> Dict[str, np.ndarray]:
    """Event records ``(event_label, onset, offset, filename)`` or a table
    -> a table; a missing label becomes None."""
    if isinstance(events, Mapping):
        cols = {k: events[k] for k in COLUMNS}
    else:
        rows = list(events)
        cols = dict(zip(COLUMNS, zip(*rows))) if rows else {
            k: () for k in COLUMNS}
    lab = np.empty(len(cols["event_label"]), object)
    lab[:] = [x if is_label(x) else None for x in cols["event_label"]]
    fn = np.empty(len(cols["filename"]), object)
    fn[:] = list(cols["filename"])
    return {"event_label": lab, "onset": np.asarray(cols["onset"], float),
            "offset": np.asarray(cols["offset"], float), "filename": fn}


def _select(table, keep) -> Dict[str, np.ndarray]:
    return {k: v[keep] for k, v in table.items()}


def _intersection(a_on, a_off, b_on, b_off):
    return np.maximum(
        0.0, np.minimum(a_off, b_off) - np.maximum(a_on, b_on))


def _codes(values, index: Dict) -> np.ndarray:
    """Integer codes of ``values``, new ones added to ``index``."""
    return np.asarray([index.setdefault(v, len(index)) for v in values],
                      np.int64)


def _pairs(left_key, right_key):
    """The inner join of two integer key columns, as pandas' merge orders
    it: (left row, right row) pairs by left row, each left row's matches in
    right row order."""
    order = np.argsort(right_key, kind="stable")
    sk = right_key[order]
    lo = np.searchsorted(sk, left_key, side="left")
    hi = np.searchsorted(sk, left_key, side="right")
    n = hi - lo
    li = np.repeat(np.arange(len(left_key)), n)
    starts = np.repeat(lo - np.cumsum(n) + n, n)
    ri = order[starts + np.arange(n.sum())]
    return li, ri


def _per_op_counts(det, gt, classes: List[str], cfg: PSDSConfig):
    """One operating point -> (tp [C], fp [C], ct [C, C])."""
    C = len(classes)
    cidx = {c: i for i, c in enumerate(classes)}
    tp = np.zeros(C)
    fp = np.zeros(C)
    ct = np.zeros((C, C))

    # detections of classes with no ground truth can score no TP and have
    # no FP bucket: dropped (psds_eval keeps the ground truth's classes)
    det = _select(det, np.asarray([c in cidx for c in det["event_label"]],
                                  bool))
    d_cls = np.asarray([cidx[c] for c in det["event_label"]], np.int64)
    g_cls = np.asarray([cidx[c] for c in gt["event_label"]], np.int64)
    files: Dict = {}
    d_file = _codes(det["filename"], files)
    g_file = _codes(gt["filename"], files)
    dur = det["offset"] - det["onset"]
    g_dur = gt["offset"] - gt["onset"]

    # same-class, same-file pairs and their intersections
    di, gi = _pairs(d_file * C + d_cls, g_file * C + g_cls)
    inter = _intersection(det["onset"][di], det["offset"][di],
                          gt["onset"][gi], gt["offset"][gi])

    # DTC: the summed same-class intersection covers >= dtc of the detection
    dtc_ratio = np.bincount(di, weights=inter, minlength=len(dur))
    with np.errstate(divide="ignore", invalid="ignore"):
        dtc_ratio = np.where(dur > 0, dtc_ratio / np.maximum(dur, 1e-30),
                             0.0)
    dtc_valid = dtc_ratio >= cfg.dtc_threshold

    # GTC: ground truths covered >= gtc by DTC-valid detections
    if len(di):
        pv = dtc_valid[di]
        cov = np.bincount(gi[pv], weights=inter[pv], minlength=len(g_dur))
        ok = (g_dur > 0) & (cov / np.maximum(g_dur, 1e-30)
                            >= cfg.gtc_threshold)
        np.add.at(tp, g_cls[ok], 1)

    # FPs: detections failing DTC
    inval = np.nonzero(~dtc_valid)[0]
    np.add.at(fp, d_cls[inval], 1)

    # CTTC: invalid detections against other classes' ground truths
    if cfg.alpha_ct > 0 and len(inval):
        li, gi = _pairs(d_file[inval], g_file)
        di = inval[li]
        other = d_cls[di] != g_cls[gi]
        di, gi = di[other], gi[other]
        if len(di):
            inter = _intersection(det["onset"][di], det["offset"][di],
                                  gt["onset"][gi], gt["offset"][gi])
            # groupby(["det_id", "event_label_gt"])
            keys, first, group = np.unique(di * C + g_cls[gi],
                                           return_index=True,
                                           return_inverse=True)
            s = np.bincount(group, weights=inter, minlength=len(keys))
            gd = di[first]
            hit = (dur[gd] > 0) & (s / np.maximum(dur[gd], 1e-30)
                                   >= cfg.cttc_threshold)
            np.add.at(ct, (d_cls[gd[hit]], g_cls[gi[first][hit]]), 1)
    return tp, fp, ct


def compute_psds(detections: Mapping, ground_truth, durations,
                 dtc_threshold: float = 0.5,
                 gtc_threshold: float = 0.5,
                 cttc_threshold: float = 0.3,
                 alpha_ct: float = 0.0,
                 alpha_st: float = 0.0,
                 e_max: float = 100.0) -> float:
    """detections: {operating point: events}; ground_truth: events;
    durations: a table of filename and duration (seconds). -> PSDS in
    [0, 1]. Detections and ground truths without a label are dropped, and
    the classes are the ground truth's, sorted."""
    cfg = PSDSConfig(dtc_threshold, gtc_threshold, cttc_threshold,
                     alpha_ct, alpha_st, e_max)
    gt = event_table(ground_truth)
    gt = _select(gt, np.asarray([c is not None for c in gt["event_label"]],
                                bool))
    classes = sorted(set(gt["event_label"]))
    C = len(classes)
    total_hours = np.sum(np.asarray(durations["duration"], float)) / 3600.0
    n_gt = np.array([(gt["event_label"] == c).sum() for c in classes],
                    dtype=np.float64)
    gt_dur_per_class = np.array([
        np.sum((gt["offset"] - gt["onset"])[gt["event_label"] == c])
        for c in classes]) / 3600.0
    off_diag = ~np.eye(C, dtype=bool)

    ops = []
    for det in detections.values():
        det = event_table(det)
        det = _select(det, np.asarray(
            [c is not None for c in det["event_label"]], bool))
        tp, fp, ct = _per_op_counts(det, gt, classes, cfg)
        tpr = np.divide(tp, n_gt, out=np.zeros(C), where=n_gt > 0)
        efpr = fp / max(total_hours, 1e-9)
        if cfg.alpha_ct > 0:
            # the mean cross-trigger rate over the other classes
            rates = ct / np.maximum(gt_dur_per_class, 1e-9)[None, :]
            ctr = (rates[off_diag].reshape(C, C - 1).mean(axis=1)
                   if C > 1 else np.zeros(C))
            efpr = efpr + cfg.alpha_ct * ctr
        ops.append((tpr, efpr))

    # PSD-ROC as psds_eval (psds.py:700-786, 1004-1078): a zero operating
    # point per class, each class's running-max staircase evaluated at the
    # union of all eFPR breakpoints (left step), then mean - alpha_st * std
    # integrated with left rectangles up to e_max
    tprs = np.stack([op[0] for op in ops] + [np.zeros(C)], axis=0)
    efprs = np.stack([op[1] for op in ops] + [np.zeros(C)], axis=0)
    xp = np.unique(efprs[np.isfinite(efprs)])
    curves = np.zeros((C, xp.size))
    for c in range(C):
        order = np.argsort(efprs[:, c], kind="stable")
        xs = efprs[order, c]
        ys = np.maximum.accumulate(tprs[order, c])
        idx = np.searchsorted(xs, xp, side="right") - 1
        curves[c] = np.where(idx >= 0, ys[np.maximum(idx, 0)], 0.0)
    etpr = curves.mean(axis=0) - alpha_st * curves.std(axis=0)
    etpr = np.maximum(np.nan_to_num(etpr), 0.0)
    # left-rectangle area over [0, e_max] (psds_eval._auc inserts e_max
    # carrying the previous y)
    if e_max not in xp:
        k = int(np.searchsorted(xp, e_max))
        xp = np.insert(xp, k, e_max)
        etpr = np.insert(etpr, k, etpr[k - 1] if k > 0 else 0.0)
    m = xp <= e_max
    return float(np.sum(np.diff(xp[m]) * etpr[m][:-1]) / e_max)


def _groups(table) -> Dict:
    """(event_label, filename) -> (onsets, offsets) in row order, labelled
    rows only (pandas' ``groupby(sort=False)``)."""
    rows: Dict = {}
    for i, key in enumerate(zip(table["event_label"], table["filename"])):
        if key[0] is not None:
            rows.setdefault(key, []).append(i)
    return {k: (table["onset"][v], table["offset"][v])
            for k, v in rows.items()}


def event_based_f1(detections, ground_truth, t_collar: float = 0.2,
                   percentage_of_length: float = 0.2) -> float:
    """sed_eval-style event-based macro F1 with onset/offset collars
    (reference log_sedeval_metrics, gpu_decode.py:313-401): per class and
    file, each ground truth in row order takes the first unused detection
    within its collars."""
    det, gt = event_table(detections), event_table(ground_truth)
    classes = sorted({c for c in gt["event_label"] if c is not None})
    cidx = {c: i for i, c in enumerate(classes)}
    tp = np.zeros(len(classes))
    n_det = np.zeros(len(classes))
    n_gt = np.zeros(len(classes))
    for c in det["event_label"]:
        if c in cidx:
            n_det[cidx[c]] += 1
    for c in gt["event_label"]:
        if c is not None:
            n_gt[cidx[c]] += 1

    dg = _groups(det)
    for key, (g_on, g_off) in _groups(gt).items():
        if key not in dg:
            continue
        d_on, d_off = dg[key]
        off_collar = np.maximum(t_collar,
                                percentage_of_length * (g_off - g_on))
        # elig[i, j]: detection j within the collars of ground truth i
        elig = ((np.abs(d_on[None, :] - g_on[:, None]) <= t_collar) &
                (np.abs(d_off[None, :] - g_off[:, None])
                 <= off_collar[:, None]))
        used = np.zeros(len(d_on), bool)
        hits = 0
        for i in range(len(g_on)):  # greedy: the first unused eligible
            cand = elig[i] & ~used
            j = int(np.argmax(cand))
            if cand[j]:
                used[j] = True
                hits += 1
        tp[cidx[key[0]]] += hits

    fp = n_det - tp
    fn = n_gt - tp
    denom = tp + 0.5 * (fp + fn)
    f1s = np.where(denom > 0, tp / np.maximum(denom, 1e-12), 0.0)
    return float(np.mean(f1s)) if len(classes) else 0.0
