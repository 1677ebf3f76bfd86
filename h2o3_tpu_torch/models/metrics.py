"""Model metrics: AUC, confusion matrix, logloss, gains/lift and KS,
regression errors and deviances, multinomial logloss / confusion matrix
/ hit ratios, autoencoder reconstruction error, clustering sums of
squares (counterpart of
h2o3_tpu/models/metrics.py).

AUC keeps the reference's fixed 400-bin score histogram (hex/AUC2.java:36):
one device pass accumulates per-bin positive/negative weight, the ROC
sweep and the gains/lift table (`gains_lift`, metrics.py:268) run on the
host over the same histogram.

The sums behind logloss, MSE and the other means are the order-free
fixed-point sums of the per-row float32 terms (core/ops.fixed_point_sums):
the same bits on the card, on the CPU and for any split of the rows.
On a row-sharded cloud (``mesh=``) each rank makes them and the score
histograms over its rows and the row mesh sums them (the histograms'
float64 bins); `compute_auc` and the gains/lift table then run on the
reduced histograms, the same on every rank. With unit weights the
histograms count rows, so the AUC is the one-process AUC exactly, and
the other metrics are one process's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import widen
from h2o3_tpu_torch.core.ops import fixed_point_sums, segment_sum

NBINS = 400


def _binomial_hist(y, p, w, nbins: int = NBINS, mesh=None):
    """Per-bin weight of positives and of negatives over predicted P(1),
    summed over the ranks of `mesh`."""
    b = torch.clamp((p * nbins).int(), 0, nbins - 1).long()
    pos, neg = (segment_sum(b, w * y, nbins),
                segment_sum(b, w * (1.0 - y), nbins))
    if mesh is None:
        return pos, neg
    both = mesh.all_reduce(torch.stack([pos, neg]).double().contiguous(),
                           "sum").to(pos.dtype)     # one rounding, as one
    return both[0], both[1]                         # process's sums have


def _reduced(parts: dict, mesh) -> dict:
    """Per-row float32 terms -> their sums as host floats: the
    fixed-point sums over this process's rows, or over every rank of
    `mesh`."""
    keys = sorted(parts)
    rows = torch.stack([parts[k].reshape(-1).float() for k in keys], 1)
    vals = fixed_point_sums(rows, mesh).tolist()
    return dict(zip(keys, vals))


def _regression_partials(y, f, w):
    d = y - f
    return {"wsum": w, "se": w * d * d, "ae": w * torch.abs(d),
            "ysum": w * y, "y2sum": w * y * y,
            "sle": w * (torch.log1p(torch.clamp_min(f, 0))
                        - torch.log1p(torch.clamp_min(y, 0))) ** 2}


def _binomial_partials(y, p, w):
    eps = 1e-15
    pc = torch.clamp(p, eps, 1 - eps)
    ll = -(w * (y * torch.log(pc) + (1 - y) * torch.log1p(-pc)))
    return {"logloss": ll, "se": w * (y - p) ** 2, "wsum": w}


def _multinomial_partials(y, probs, w, nclasses: int):
    eps = 1e-15
    yi = y.long()
    pred = torch.argmax(probs, dim=-1)
    rows = torch.arange(y.shape[0], device=y.device)
    py = torch.clamp(probs[rows, yi], eps, 1.0)
    ll = -(w * torch.log(py))
    cm = segment_sum(yi * nclasses + pred, w, nclasses * nclasses)
    other = torch.where(torch.arange(nclasses, device=y.device)[None, :]
                        == yi[:, None], 0.0, probs)
    se = w * (1.0 - py) ** 2 + torch.sum(w[:, None] * other ** 2, dim=1)
    # top-k hit counts (the reference's hit_ratio_table, k up to 10)
    k = min(10, nclasses)
    topk = torch.argsort(-probs, dim=-1, stable=True)[:, :k]
    hitk = torch.cumsum((topk == yi[:, None]).to(w.dtype), dim=-1) \
        * w[:, None]
    return {"logloss": ll, "cm": cm.reshape(nclasses, nclasses), "se": se,
            "wsum": w, "hitk": torch.sum(hitk, dim=0)}


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

    def to_dict(self):
        """The shared fields under their wire names (the REST schema's
        fallback for a family it has no schema of, as an autoencoder's)."""
        return {"MSE": self.mse, "RMSE": self.rmse, "nobs": self.nobs}


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
    ks: float = float("nan")              # Kolmogorov-Smirnov
    cm: Optional[ConfusionMatrix] = None
    auc_data: Optional[AUCData] = None
    gains_lift_table = None               # TwoDimTable (not a field)


@dataclass
class ModelMetricsMultinomial(ModelMetrics):
    logloss: float = float("nan")
    mean_per_class_error: float = float("nan")
    cm: Optional[ConfusionMatrix] = None
    hit_ratios: Optional[List[float]] = None


@dataclass
class ModelMetricsAutoEncoder(ModelMetrics):
    """Reconstruction error: the MSE over the expanded input space."""


@dataclass
class ModelMetricsClustering(ModelMetrics):
    """Within-cluster, between-cluster and total sums of squares, and
    the rows of each cluster."""
    tot_withinss: float = float("nan")
    betweenss: float = float("nan")
    totss: float = float("nan")
    within_cluster_sizes: Optional[List[float]] = None


def gains_lift(pos_hist: np.ndarray, neg_hist: np.ndarray, groups: int = 16):
    """Gains/lift table from the score histograms: quantile groups over
    descending predicted probability, per group and cumulative response
    rate, lift, capture and gain, and the KS statistic over every bin.
    Returns (TwoDimTable, ks)."""
    from h2o3_tpu_torch.utils.twodim import TwoDimTable

    pos = np.asarray(pos_hist, np.float64)[::-1]      # descending p
    tot = pos + np.asarray(neg_hist, np.float64)[::-1]
    W = tot.sum()
    P = pos.sum()
    t = TwoDimTable("Gains/Lift Table",
                    ["group", "cumulative_data_fraction",
                     "lower_threshold", "response_rate", "lift",
                     "cumulative_response_rate", "cumulative_lift",
                     "capture_rate", "cumulative_capture_rate", "gain",
                     "cumulative_gain", "kolmogorov_smirnov"],
                    ["int"] + ["double"] * 11)
    if W <= 0 or P <= 0 or P >= W:
        return t, float("nan")
    rate = P / W
    nb = len(tot)
    cw = np.cumsum(tot)
    cp = np.cumsum(pos)
    ks_all = np.max(np.abs(cp / P - (cw - cp) / (W - P)))
    prev_w = prev_p = 0.0
    for g in range(1, groups + 1):
        target = W * g / groups
        i = min(int(np.searchsorted(cw, target - 1e-9)), nb - 1)
        cum_w, cum_p = float(cw[i]), float(cp[i])
        if cum_w <= prev_w:
            continue
        gw, gp = cum_w - prev_w, cum_p - prev_p
        resp = gp / gw
        cum_resp = cum_p / cum_w
        ks = abs(cum_p / P - (cum_w - cum_p) / (W - P))
        t.add_row(g, cum_w / W, 1.0 - (i + 1) / nb, resp, resp / rate,
                  cum_resp, cum_resp / rate, gp / P, cum_p / P,
                  100 * (resp / rate - 1), 100 * (cum_resp / rate - 1), ks)
        prev_w, prev_p = cum_w, cum_p
    return t, float(ks_all)


def make_regression_metrics(y, f, w, distribution=None, mesh=None
                            ) -> ModelMetricsRegression:
    """Regression metrics; y/f/w are (N,) tensors, f on the response
    scale. The mean residual deviance is the distribution's (gaussian:
    the MSE). A bf16 response widens first: torch would keep bf16 for
    its terms with Python-scalar exponents (ROADMAP C41)."""
    y = widen(y)
    terms = _regression_partials(y, f, w)
    if distribution is not None and distribution.name != "gaussian":
        # log-link families score on the response scale: back to margins
        fm = (distribution.link(torch.clamp_min(f, 1e-10))
              if distribution.name in ("poisson", "gamma", "tweedie") else f)
        terms["dev"] = distribution.deviance(w, y, fm)
    # one pass of fixed-point sums for every term (each column its own
    # scale, so a term's sum does not depend on the others)
    parts = _reduced(terms, mesh)
    wsum = parts["wsum"]
    if wsum == 0:
        return ModelMetricsRegression()
    mse = parts["se"] / wsum
    ymean = parts["ysum"] / wsum
    ss_tot = parts["y2sum"] / wsum - ymean * ymean
    dev = parts["dev"] / wsum if "dev" in parts else mse
    return ModelMetricsRegression(
        mse=mse, rmse=float(np.sqrt(mse)), nobs=wsum,
        mae=parts["ae"] / wsum, rmsle=float(np.sqrt(parts["sle"] / wsum)),
        r2=1.0 - mse / ss_tot if ss_tot > 0 else float("nan"),
        mean_residual_deviance=dev)


def make_binomial_metrics(y, p, w, domain: Optional[List[str]] = None,
                          mesh=None) -> ModelMetricsBinomial:
    """y in {0,1}, p = P(class 1); all (N,) tensors."""
    parts = _reduced(_binomial_partials(y, p, w), mesh)
    pos, neg = _binomial_hist(y, p, w, mesh=mesh)
    pos, neg = pos.cpu().numpy(), neg.cpu().numpy()
    auc = compute_auc(pos, neg)
    wsum = parts["wsum"]
    if wsum == 0:
        return ModelMetricsBinomial()
    cm = auc.confusion_matrix(domain=domain)
    mse = parts["se"] / wsum
    gl, ks = gains_lift(pos, neg)
    mm = ModelMetricsBinomial(
        mse=mse, rmse=float(np.sqrt(mse)), nobs=wsum,
        logloss=parts["logloss"] / wsum, auc=auc.auc, pr_auc=auc.pr_auc,
        gini=auc.gini, mean_per_class_error=float(np.mean(
            cm.errors_per_class())), ks=ks, cm=cm, auc_data=auc)
    mm.gains_lift_table = gl
    return mm


def make_multinomial_metrics(y, probs, w, domain: List[str], mesh=None
                             ) -> ModelMetricsMultinomial:
    """y (N,) class codes, probs (N, K); all tensors."""
    k = len(domain)
    parts = _multinomial_partials(y, probs, w, k)
    sums = _reduced({key: parts.pop(key) for key in ("logloss", "se",
                                                     "wsum")}, mesh)
    if mesh is not None:
        for key in ("cm", "hitk"):
            parts[key] = mesh.all_reduce(parts[key].double().contiguous(),
                                         "sum")
    parts.update(sums)
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
