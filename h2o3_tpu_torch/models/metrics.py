"""Model metrics: AUC, confusion matrix, logloss, regression errors and
deviances, multinomial logloss / confusion matrix / hit ratios
(counterpart of h2o3_tpu/models/metrics.py).

AUC keeps the reference's fixed 400-bin score histogram (hex/AUC2.java:36):
one device pass accumulates per-bin positive/negative weight, the ROC
sweep runs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.ops import segment_sum

NBINS = 400


def _binomial_hist(y, p, w, nbins: int = NBINS):
    """Per-bin weight of positives and of negatives over predicted P(1)."""
    b = torch.clamp((p * nbins).int(), 0, nbins - 1).long()
    return (segment_sum(b, w * y, nbins),
            segment_sum(b, w * (1.0 - y), nbins))


def _regression_partials(y, f, w):
    d = y - f
    return {"wsum": torch.sum(w), "se": torch.sum(w * d * d),
            "ae": torch.sum(w * torch.abs(d)), "ysum": torch.sum(w * y),
            "y2sum": torch.sum(w * y * y),
            "sle": torch.sum(w * (torch.log1p(torch.clamp_min(f, 0))
                                  - torch.log1p(torch.clamp_min(y, 0))) ** 2)}


def _binomial_partials(y, p, w):
    eps = 1e-15
    pc = torch.clamp(p, eps, 1 - eps)
    ll = -torch.sum(w * (y * torch.log(pc) + (1 - y) * torch.log1p(-pc)))
    return {"logloss": ll, "se": torch.sum(w * (y - p) ** 2),
            "wsum": torch.sum(w)}


def _multinomial_partials(y, probs, w, nclasses: int):
    eps = 1e-15
    yi = y.long()
    pred = torch.argmax(probs, dim=-1)
    rows = torch.arange(y.shape[0], device=y.device)
    py = torch.clamp(probs[rows, yi], eps, 1.0)
    ll = -torch.sum(w * torch.log(py))
    cm = segment_sum(yi * nclasses + pred, w, nclasses * nclasses)
    other = torch.where(torch.arange(nclasses, device=y.device)[None, :]
                        == yi[:, None], 0.0, probs)
    se = torch.sum(w * (1.0 - py) ** 2) + torch.sum(w[:, None] * other ** 2)
    # top-k hit counts (the reference's hit_ratio_table, k up to 10)
    k = min(10, nclasses)
    topk = torch.argsort(-probs, dim=-1, stable=True)[:, :k]
    hitk = torch.cumsum((topk == yi[:, None]).to(w.dtype), dim=-1) \
        * w[:, None]
    return {"logloss": ll, "cm": cm.reshape(nclasses, nclasses), "se": se,
            "wsum": torch.sum(w), "hitk": torch.sum(hitk, dim=0)}


@dataclass
class ConfusionMatrix:
    """Rows = actual, cols = predicted."""

    table: np.ndarray
    domain: List[str]

    def errors_per_class(self) -> np.ndarray:
        tot = self.table.sum(axis=1)
        correct = np.diag(self.table)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(tot > 0, (tot - correct) / tot, 0.0)

    @property
    def error(self) -> float:
        tot = self.table.sum()
        return float((tot - np.diag(self.table).sum()) / tot) if tot else 0.0


@dataclass
class AUCData:
    """ROC from the 400-bin histogram plus the max-F1 threshold."""

    auc: float
    pr_auc: float
    gini: float
    max_f1: float
    max_f1_threshold: float
    thresholds: np.ndarray = field(repr=False)
    tps: np.ndarray = field(repr=False)
    fps: np.ndarray = field(repr=False)
    p: float = 0.0
    n: float = 0.0

    def confusion_matrix(self, threshold: Optional[float] = None,
                         domain: Optional[List[str]] = None
                         ) -> ConfusionMatrix:
        thr = self.max_f1_threshold if threshold is None else threshold
        i = int(np.searchsorted(-self.thresholds, -thr))
        i = min(i, len(self.thresholds) - 1)
        tp, fp = self.tps[i], self.fps[i]
        fn, tn = self.p - tp, self.n - fp
        return ConfusionMatrix(np.array([[tn, fp], [fn, tp]]),
                               domain or ["0", "1"])


def compute_auc(pos_hist: np.ndarray, neg_hist: np.ndarray) -> AUCData:
    """ROC sweep over descending-threshold bins."""
    pos = pos_hist[::-1]
    neg = neg_hist[::-1]
    tps = np.cumsum(pos)
    fps = np.cumsum(neg)
    p, n = float(tps[-1]), float(fps[-1])
    if p == 0 or n == 0:
        return AUCData(0.5, 0.0, 0.0, 0.0, 0.5,
                       np.linspace(1, 0, NBINS), tps, fps, p, n)
    tpr = tps / p
    fpr = fps / n
    auc = float(np.trapezoid(np.concatenate([[0.0], tpr]),
                             np.concatenate([[0.0], fpr])))
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.where(tps + fps > 0, tps / (tps + fps), 1.0)
        recall = tpr
        pr_auc = float(np.trapezoid(precision, recall))
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    thresholds = (np.arange(NBINS, 0, -1) - 0.5) / NBINS
    best = int(np.argmax(f1))
    return AUCData(auc=auc, pr_auc=pr_auc, gini=2 * auc - 1,
                   max_f1=float(f1[best]),
                   max_f1_threshold=float(thresholds[best]),
                   thresholds=thresholds, tps=tps, fps=fps, p=p, n=n)


@dataclass
class ModelMetrics:
    mse: float = float("nan")
    rmse: float = float("nan")
    nobs: float = 0.0
    description: str = ""


@dataclass
class ModelMetricsRegression(ModelMetrics):
    mae: float = float("nan")
    rmsle: float = float("nan")
    r2: float = float("nan")
    mean_residual_deviance: float = float("nan")


@dataclass
class ModelMetricsBinomial(ModelMetrics):
    logloss: float = float("nan")
    auc: float = float("nan")
    pr_auc: float = float("nan")
    gini: float = float("nan")
    mean_per_class_error: float = float("nan")
    cm: Optional[ConfusionMatrix] = None
    auc_data: Optional[AUCData] = None


@dataclass
class ModelMetricsMultinomial(ModelMetrics):
    logloss: float = float("nan")
    mean_per_class_error: float = float("nan")
    cm: Optional[ConfusionMatrix] = None
    hit_ratios: Optional[List[float]] = None


def make_regression_metrics(y, f, w, distribution=None
                            ) -> ModelMetricsRegression:
    """Regression metrics; y/f/w are (N,) tensors, f on the response
    scale. The mean residual deviance is the distribution's (gaussian:
    the MSE)."""
    parts = {k: float(v) for k, v in _regression_partials(y, f, w).items()}
    wsum = parts["wsum"]
    if wsum == 0:
        return ModelMetricsRegression()
    mse = parts["se"] / wsum
    ymean = parts["ysum"] / wsum
    ss_tot = parts["y2sum"] / wsum - ymean * ymean
    dev = mse
    if distribution is not None and distribution.name != "gaussian":
        # log-link families score on the response scale: back to margins
        fm = (distribution.link(torch.clamp_min(f, 1e-10))
              if distribution.name in ("poisson", "gamma", "tweedie") else f)
        dev = float(torch.sum(distribution.deviance(w, y, fm))) / wsum
    return ModelMetricsRegression(
        mse=mse, rmse=float(np.sqrt(mse)), nobs=wsum,
        mae=parts["ae"] / wsum, rmsle=float(np.sqrt(parts["sle"] / wsum)),
        r2=1.0 - mse / ss_tot if ss_tot > 0 else float("nan"),
        mean_residual_deviance=dev)


def make_binomial_metrics(y, p, w, domain: Optional[List[str]] = None
                          ) -> ModelMetricsBinomial:
    """y in {0,1}, p = P(class 1); all (N,) tensors."""
    parts = {k: float(v) for k, v in _binomial_partials(y, p, w).items()}
    pos, neg = _binomial_hist(y, p, w)
    auc = compute_auc(pos.cpu().numpy(), neg.cpu().numpy())
    wsum = parts["wsum"]
    if wsum == 0:
        return ModelMetricsBinomial()
    cm = auc.confusion_matrix(domain=domain)
    mse = parts["se"] / wsum
    return ModelMetricsBinomial(
        mse=mse, rmse=float(np.sqrt(mse)), nobs=wsum,
        logloss=parts["logloss"] / wsum, auc=auc.auc, pr_auc=auc.pr_auc,
        gini=auc.gini, mean_per_class_error=float(np.mean(
            cm.errors_per_class())), cm=cm, auc_data=auc)


def make_multinomial_metrics(y, probs, w, domain: List[str]
                             ) -> ModelMetricsMultinomial:
    """y (N,) class codes, probs (N, K); all tensors."""
    k = len(domain)
    parts = _multinomial_partials(y, probs, w, k)
    wsum = float(parts["wsum"])
    if wsum == 0:
        return ModelMetricsMultinomial()
    cm = ConfusionMatrix(parts["cm"].cpu().numpy(), list(domain))
    mse = float(parts["se"]) / wsum
    return ModelMetricsMultinomial(
        mse=mse, rmse=float(np.sqrt(mse)), nobs=wsum,
        logloss=float(parts["logloss"]) / wsum,
        mean_per_class_error=float(np.mean(cm.errors_per_class())),
        cm=cm, hit_ratios=[float(h) / wsum
                           for h in parts["hitk"].cpu().numpy()])
