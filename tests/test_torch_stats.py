"""Port parity: ``t2v_metrics_tpu_torch.benchmarks.stats`` against the JAX
package's ``benchmarks/stats.py`` over the cases of ``tests/test_stats.py``
(the same numpy seeds and shapes), and the port's numpy ranking metrics
against ``sklearn.metrics``.

Tolerance 1e-12 everywhere: both sides compute in float64 from the same
inputs.
"""

import warnings

import numpy as np
import pytest

from t2v_metrics_tpu.benchmarks import stats as J
from t2v_metrics_tpu_torch.benchmarks import stats as T

TOL = 1e-12


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0, equal_nan=True)


@pytest.mark.parametrize("variant", ["b", "c", "23", "acc23"])
def test_kendall_variants_match_jax(variant):
    rng = np.random.default_rng(0)
    for trial in range(5):
        gold = rng.integers(0, 5, 20).astype(float)
        metric = rng.random(20)
        if trial % 2:  # metric ties
            metric = np.round(metric, 1)
        got, want = T.kendall_variants(gold, metric, variant), J.kendall_variants(
            gold, metric, variant)
        _close(got[0], want[0])
        assert got[1] == want[1] == 0


@pytest.mark.parametrize("eps", [0.05, 0.2])
def test_kendall_epsilon_matches_jax(eps):
    rng = np.random.default_rng(1)
    gold = rng.integers(0, 3, 30).astype(float)
    metric = rng.random(30)
    _close(T.kendall_variants(gold, metric, "acc23", epsilon=eps)[0],
           J.kendall_variants(gold, metric, "acc23", epsilon=eps)[0])
    assert T.KendallVariants is T.kendall_variants


def test_kendall_errors_match_jax():
    for kw in ({"epsilon": -1.0}, {"epsilon": 0.1, "variant": "c"}, {"variant": "x"}):
        with pytest.raises(ValueError):
            J.kendall_variants([1.0, 2.0], [0.1, 0.2], **kw)
        with pytest.raises(ValueError):
            T.kendall_variants([1.0, 2.0], [0.1, 0.2], **kw)


@pytest.mark.parametrize("fn_name", ["tau_23", "acc_23", "acc_ignore_tie"])
def test_tau_optimization_matches_jax(fn_name):
    rng = np.random.default_rng(2)
    metric = rng.random((6, 8))
    human = rng.integers(0, 4, (6, 8)).astype(float)
    got = T.tau_optimization(metric, human, fn_name)
    want = J.tau_optimization(metric, human, fn_name)
    for field in ("best_tau", "best_threshold", "taus", "thresholds"):
        _close(getattr(got, field), getattr(want, field))
    # the tau function may be named through the sufficient-statistics class
    got = T.tau_optimization(metric, human, getattr(T.TauSufficientStats, fn_name))
    _close(got.taus, want.taus)


def test_tau_optimization_vector_input_matches_jax():
    rng = np.random.default_rng(3)
    metric = rng.random(15)
    human = rng.integers(0, 3, 15).astype(float)
    got, want = (T.tau_optimization(metric, human, "acc_23"),
                 J.tau_optimization(metric, human, "acc_23"))
    _close(got.best_tau, want.best_tau)
    _close(got.thresholds, want.thresholds)


def test_tau_optimization_sampled_matches_jax():
    """sample_rate < 1 draws from numpy's global generator: the same seed
    gives both the same pairs."""
    rng = np.random.default_rng(7)
    metric = rng.random((4, 10))
    human = rng.integers(0, 4, (4, 10)).astype(float)
    np.random.seed(11)
    want = J.tau_optimization(metric, human, "tau_23", sample_rate=0.5)
    np.random.seed(11)
    got = T.tau_optimization(metric, human, "tau_23", sample_rate=0.5)
    _close(got.taus, want.taus)
    _close(got.thresholds, want.thresholds)


@pytest.mark.parametrize("variant", ["pairwise_acc_with_tie_optimization",
                                     "tau_with_tie_optimization", "pairwise_acc_ignore_tie",
                                     "tau_b", "tau_c"])
def test_calc_metric_variants_match_jax(variant):
    rng = np.random.default_rng(4)
    gold = rng.integers(0, 5, (4, 6)).astype(float)
    metric = rng.random((4, 6))
    got, want = T.calc_metric(gold, metric, variant), J.calc_metric(gold, metric, variant)
    _close(np.asarray(got, np.float64), np.asarray(want, np.float64))


def test_winoground_acc_matches_jax():
    scores = np.random.default_rng(5).random((10, 2, 2))
    got = T.get_winoground_scores(scores)
    assert got == J.get_winoground_scores(scores)
    assert T.get_winoground_acc(got) == J.get_winoground_acc(got)


def test_pearson_matches_jax():
    rng = np.random.default_rng(6)
    a, b = rng.random(50), rng.random(50)
    _close(T.calc_pearson(a, b), J.calc_pearson(a, b))
    assert np.isnan(T.calc_pearson(np.ones(5), a[:5]))
    assert np.isnan(J.calc_pearson(np.ones(5), a[:5]))


# ---------------------------------------------------------------------------
# ROC / precision-recall: the port's numpy functions against sklearn
# ---------------------------------------------------------------------------

def _case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    n = 40
    y = rng.integers(0, 2, n)
    s = rng.random(n)
    if kind == "tied":
        s = np.round(s, 1)
    elif kind == "single_class":
        y = np.full(n, seed % 2)
    elif kind == "non_finite":  # binary_classification_evaluation's stand-in for inf / nan
        s[rng.random(n) < 0.3] = -1e10
    elif kind == "labels_1_2":  # any two labels: the larger is the positive class
        y = y + 1
    return y, s


KINDS = ["random", "tied", "single_class", "non_finite", "labels_1_2"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn", ["roc_auc_score", "average_precision_score", "roc_curve",
                                "precision_recall_curve"])
def test_ranking_metrics_match_sklearn(kind, fn):
    metrics = pytest.importorskip("sklearn.metrics")
    if fn != "roc_auc_score" and kind == "labels_1_2":
        kw = {"pos_label": 2}   # sklearn's curves need the positive label named
    else:
        kw = {}
    for seed in range(4):
        y, s = _case(kind, seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = getattr(metrics, fn)(y, s, **kw)
            got = getattr(T, fn)(y, s)
        if isinstance(want, tuple):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                _close(g, w)
        else:
            assert isinstance(got, float)
            _close(got, want)


def test_ranking_metrics_reject_what_sklearn_rejects():
    with pytest.raises(ValueError):
        T.roc_curve([0, 1, 1], [0.1, np.inf, 0.3])
    with pytest.raises(ValueError):
        T.average_precision_score([0, 1, 2], [0.1, 0.2, 0.3])
    with pytest.warns(UserWarning, match="Only one class"):
        assert np.isnan(T.roc_auc_score([1, 1], [0.1, 0.2]))
