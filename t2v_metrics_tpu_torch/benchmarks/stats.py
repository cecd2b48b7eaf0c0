"""Correlation statistics: Pearson, tie-aware Kendall variants, Winoground
accuracy, the EMNLP'23 "Ties Matter" tau-optimization sweep, and the
binary ranking metrics (ROC / precision-recall curves, ROC-AUC, average
precision).

The port's copy of t2v_metrics_tpu/benchmarks/stats.py (numpy only), under
the same names. The four ranking metrics at the end take the place of
``sklearn.metrics``, which the GPU machine lacks: they compute sklearn's
functions with its tie handling (one threshold per distinct score, the
trapezoid for the ROC area, the step sum for average precision).

Conventions preserved:
  * a metric-score difference <= epsilon counts as a tie (human ties are
    exact equality);
  * tau_optimization starts the sweep at threshold 0.0 and overwrites the
    running tau when consecutive pairs share a diff;
  * `calc_metric` exposes the same variant names.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np


def calc_pearson(metric1_scores, metric2_scores) -> float:
    """Pearson correlation ×100 (reference dataset.py:14-16).

    Constant input has undefined correlation; return nan without the
    numpy RuntimeWarning the reference emits.
    """
    a = np.asarray(metric1_scores, np.float64)
    b = np.asarray(metric2_scores, np.float64)
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    if denom == 0.0:
        return float("nan")
    return float(100 * (a * b).sum() / denom)


# ---------------------------------------------------------------------------
# Pair sufficient statistics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TauSufficientStats:
    """Concordant/discordant/tie counts for one group of pairs."""

    con: int = 0
    dis: int = 0
    ties_human: int = 0
    ties_metric: int = 0
    ties_both: int = 0

    @property
    def num_pairs(self) -> int:
        return (self.con + self.dis + self.ties_human + self.ties_metric
                + self.ties_both)

    def tau_23(self) -> float:
        return (self.con + self.ties_both - self.dis - self.ties_human
                - self.ties_metric) / self.num_pairs

    def acc_23(self) -> float:
        return (self.con + self.ties_both) / self.num_pairs

    def acc_ignore_tie(self) -> float:
        denom = self.num_pairs - self.ties_human
        return 1.0 if denom == 0 else self.con / denom


def _pair_counts(metric: np.ndarray, human: np.ndarray, epsilon: float):
    """Counts of (con, dis, tie_metric_only, tie_human_only, tie_both) over
    all i<j pairs. Metric ties use |diff|<=epsilon; human ties are exact."""
    i, j = np.triu_indices(len(metric), k=1)
    md = metric[i] - metric[j]
    hd = human[i] - human[j]
    m_tie = np.abs(md) <= epsilon
    h_tie = hd == 0.0
    md = np.where(m_tie, 0.0, md)
    con = int(np.sum(((md > 0) & (hd > 0)) | ((md < 0) & (hd < 0))))
    t_m = int(np.sum(m_tie & ~h_tie))
    t_h = int(np.sum(~m_tie & h_tie))
    t_mh = int(np.sum(m_tie & h_tie))
    dis = len(i) - con - t_m - t_h - t_mh
    return con, dis, t_m, t_h, t_mh


def kendall_variants(gold_scores, metric_scores, variant: str = "acc23",
                     epsilon: float = 0.0) -> tuple[float, float]:
    """Tie-aware Kendall statistic (reference dataset.py:69-149).

    Returns (statistic, 0) for scipy.kendalltau call-compat.
    """
    if epsilon < 0:
        raise ValueError("epsilon must be non-negative")
    if epsilon > 0 and variant == "c":
        raise ValueError("non-zero epsilon with tau-c not supported")

    x = np.asarray(metric_scores, dtype=np.float64)
    y = np.asarray(gold_scores, dtype=np.float64)
    assert not np.any(np.isnan(x)) and not np.any(np.isnan(y))

    con, dis, t_x, t_y, t_xy = _pair_counts(x, y, epsilon)
    tot = con + dis + t_x + t_y + t_xy
    xtie, ytie = t_x + t_xy, t_y + t_xy

    if variant in ("b", "c") and (xtie == tot or ytie == tot):
        return np.nan, 0
    if variant == "b":
        return (con - dis) / np.sqrt(tot - xtie) / np.sqrt(tot - ytie), 0
    if variant == "c":
        k = min(len(set(x.tolist())), len(set(y.tolist())))
        return 2 * (con - dis) / (y.size ** 2 * (k - 1) / k), 0
    if variant == "23":
        return (con + t_xy - dis - t_x - t_y) / tot, 0
    if variant == "acc23":
        return (con + t_xy) / tot, 0
    raise ValueError(f"unknown variant {variant!r}")


# Reference-name alias (dataset.py imports `KendallVariants`).
KendallVariants = kendall_variants


# ---------------------------------------------------------------------------
# Tau optimization (EMNLP'23 "Ties Matter")
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TauOptimizationResult:
    thresholds: list
    taus: list
    best_threshold: float
    best_tau: float


# Pair-class codes used by the sweep's count matrix columns.
_CON, _DIS, _TH, _TM, _TBOTH = 0, 1, 2, 3, 4


def _tau_from_counts(counts: np.ndarray, tau_fn_name: str) -> np.ndarray:
    """Vectorized per-row tau from a (rows, 5) count matrix."""
    con = counts[:, _CON]
    dis = counts[:, _DIS]
    th = counts[:, _TH]
    tm = counts[:, _TM]
    tb = counts[:, _TBOTH]
    tot = counts.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        if tau_fn_name == "tau_23":
            return (con + tb - dis - th - tm) / tot
        if tau_fn_name == "acc_23":
            return (con + tb) / tot
        if tau_fn_name == "acc_ignore_tie":
            denom = tot - th
            return np.where(denom == 0, 1.0, con / np.maximum(denom, 1))
    raise ValueError(tau_fn_name)


def _resolve_tau_fn(tau_fn) -> str:
    if isinstance(tau_fn, str):
        return tau_fn
    name = getattr(tau_fn, "__name__", None)
    if name in ("tau_23", "acc_23", "acc_ignore_tie"):
        return name
    raise ValueError(f"unsupported tau_fn {tau_fn!r}")


def tau_optimization(metric_scores, human_scores, tau_fn,
                     sample_rate: float = 1.0) -> TauOptimizationResult:
    """Sweep tie thresholds over metric-score diffs, maximizing the mean
    per-row tau (reference tau_optimization.py:203-299).

    metric_scores / human_scores: (N, M) matrices (vectors get a dummy row).
    tau_fn: TauSufficientStats.{tau_23, acc_23, acc_ignore_tie} or the name.
    """
    if not (0 < sample_rate <= 1):
        raise ValueError(f"sample_rate must be in (0, 1]; got {sample_rate}")
    tau_name = _resolve_tau_fn(tau_fn)

    metric = np.array(metric_scores)
    human = np.array(human_scores)
    if metric.ndim == 1:
        metric = metric[None]
    if human.ndim == 1:
        human = human[None]
    if metric.shape != human.shape:
        raise ValueError("human and metric scores must have the same shape")

    # Enumerate pairs per row (None entries filtered; object arrays allowed).
    rows_list, diffs_list, cls_list = [], [], []
    for r in range(metric.shape[0]):
        mrow, hrow = metric[r], human[r]
        keep = [(m, h) for m, h in zip(mrow, hrow)
                if m is not None and h is not None]
        if not keep:
            continue
        m = np.asarray([v[0] for v in keep], dtype=np.float64)
        h = np.asarray([v[1] for v in keep], dtype=np.float64)
        i, j = np.triu_indices(len(m), k=1)
        if sample_rate < 1.0:
            sel = np.random.random(len(i)) <= sample_rate
            i, j = i[sel], j[sel]
        if len(i) == 0:
            continue
        md, hd = m[i] - m[j], h[i] - h[j]
        cls = np.where((hd == 0) & (md == 0), _TBOTH,
               np.where(hd == 0, _TH,
                np.where(md == 0, _TM,
                 np.where(((hd > 0) & (md > 0)) | ((hd < 0) & (md < 0)),
                          _CON, _DIS))))
        rows_list.append(np.full(len(i), r))
        diffs_list.append(np.abs(md))
        cls_list.append(cls)

    pair_row = np.concatenate(rows_list)
    pair_diff = np.concatenate(diffs_list)
    pair_cls = np.concatenate(cls_list)

    used_rows = np.unique(pair_row)
    row_index = {r: k for k, r in enumerate(used_rows)}
    nrows = len(used_rows)
    counts = np.zeros((nrows, 5), dtype=np.int64)
    compact = np.array([row_index[r] for r in pair_row])
    np.add.at(counts, (compact, pair_cls), 1)

    taus_row = _tau_from_counts(counts, tau_name)
    total = float(np.nansum(taus_row))
    thresholds = [0.0]
    taus = [total / nrows]

    order = np.argsort(pair_diff, kind="stable")
    for p in order:
        r = compact[p]
        total -= taus_row[r]
        counts[r, pair_cls[p]] -= 1
        # tie introduced: both-tie if human-tied, else metric-only tie
        new_cls = _TBOTH if pair_cls[p] in (_TH, _TBOTH) else _TM
        counts[r, new_cls] += 1
        taus_row[r] = _tau_from_counts(counts[r:r + 1], tau_name)[0]
        total += taus_row[r]
        d = float(pair_diff[p])
        if thresholds[-1] == d:
            taus[-1] = total / nrows
        else:
            thresholds.append(d)
            taus.append(total / nrows)

    best = int(np.nanargmax(taus))
    return TauOptimizationResult(thresholds, taus, thresholds[best], taus[best])


# ---------------------------------------------------------------------------
# calc_metric dispatch + Winoground accuracy
# ---------------------------------------------------------------------------

def calc_metric(gold_scores, metric_scores,
                variant: str = "pairwise_acc_with_tie_optimization",
                sample_rate: float = 1.0):
    """Variant dispatch (reference dataset.py:151-188)."""
    gold = np.array(gold_scores)
    metric = np.array(metric_scores)
    assert gold.shape == metric.shape
    if gold.ndim == 1:
        gold = gold.reshape(1, -1)
        metric = metric.reshape(1, -1)

    if variant == "pairwise_acc_with_tie_optimization":
        r = tau_optimization(metric, gold, "acc_23", sample_rate=sample_rate)
        return r.best_tau, r.best_threshold
    if variant == "pairwise_acc_ignore_tie":
        r = tau_optimization(metric, gold, "acc_ignore_tie", sample_rate=sample_rate)
        return r.taus[0], r.thresholds[0]
    if variant == "tau_with_tie_optimization":
        r = tau_optimization(metric, gold, "tau_23", sample_rate=sample_rate)
        return r.best_tau, r.best_threshold
    if variant in ("tau_b", "tau_c"):
        taus = [kendall_variants(g, m, variant=variant[-1])[0]
                for g, m in zip(gold, metric)]
        valid = [t for t in taus if not np.isnan(t)]
        return float(np.mean(valid)) if valid else float("nan")
    raise ValueError(f"unknown variant {variant!r}")


def get_winoground_scores(scores_i2t: np.ndarray) -> list[dict]:
    """(N, 2 images, 2 captions) score tensors -> per-group dicts
    (reference dataset.py:190-201)."""
    out = []
    for idx, s in enumerate(scores_i2t):
        out.append({"id": idx,
                    "c0_i0": s[0][0], "c0_i1": s[1][0],
                    "c1_i0": s[0][1], "c1_i1": s[1][1]})
    return out


def get_winoground_acc(scores: list[dict]) -> dict:
    """Text/image/group accuracy (reference dataset.py:203-227)."""
    def text_ok(r):
        return r["c0_i0"] > r["c1_i0"] and r["c1_i1"] > r["c0_i1"]

    def image_ok(r):
        return r["c0_i0"] > r["c0_i1"] and r["c1_i1"] > r["c1_i0"]

    n = len(scores)
    t = sum(text_ok(r) for r in scores)
    i = sum(image_ok(r) for r in scores)
    g = sum(text_ok(r) and image_ok(r) for r in scores)
    return {"text": t / n, "image": i / n, "group": g / n}


# ---------------------------------------------------------------------------
# Binary ranking metrics (sklearn.metrics' definitions)
# ---------------------------------------------------------------------------

def _binary_labels(y_true) -> np.ndarray:
    """0/1 labels: the larger of two classes is the positive one (sklearn's
    ``label_binarize``); one class counts as positive only when it is 1."""
    y = np.asarray(y_true).ravel()
    classes = np.unique(y)
    if len(classes) > 2:
        raise ValueError(f"binary labels expected, got {len(classes)} classes")
    pos = classes[-1] if len(classes) == 2 else 1
    return (y == pos).astype(np.float64)


def _clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, in descending order:
    the false and true positives among the samples scored at or above it."""
    y = _binary_labels(y_true)
    score = np.asarray(y_score, np.float64).ravel()
    if len(y) != len(score):
        raise ValueError(f"{len(y)} labels for {len(score)} scores")
    if not np.isfinite(score).all():
        raise ValueError("scores must be finite")
    order = np.argsort(-score, kind="stable")
    score, y = score[order], y[order]
    idx = np.r_[np.nonzero(np.diff(score))[0], len(y) - 1]
    tps = np.cumsum(y, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, score[idx]


def roc_curve(y_true, y_score, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds), thresholds starting at +inf; collinear inner
    points dropped as sklearn does (they do not change the area)."""
    fps, tps, thr = _clf_curve(y_true, y_score)
    if drop_intermediate and len(fps) > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                                True])[0]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    fps, tps, thr = np.r_[0.0, fps], np.r_[0.0, tps], np.r_[np.inf, thr]
    with np.errstate(invalid="ignore", divide="ignore"):
        fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
        tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thr


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds) in sklearn's order: thresholds
    ascending, precision ending with 1 and recall with 0. Without a positive
    sample recall is 1 at every threshold."""
    fps, tps, thr = _clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[::-1]


def average_precision_score(y_true, y_score) -> float:
    """The step sum of precision over recall's decrements (no interpolation)."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def roc_auc_score(y_true, y_score) -> float:
    """The trapezoid area under the ROC curve; nan, with a warning, when
    only one class is present."""
    if len(np.unique(np.asarray(y_true))) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not "
                      "defined in that case.")
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())
