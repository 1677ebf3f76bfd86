"""NaiveBayes: per-class level counts and Gaussian conditionals
(counterpart of h2o3_tpu/models/naive_bayes.py: `_predict_raw` :36,
`default_params` :76, `_fit` :88, the one-pass accumulation :107, the
Laplace smoothing and probability and sdev floors :133-160).

One pass over the frame's device builds every table: class weights
(the priors), per categorical predictor a (classes, levels) count
table, and per numeric predictor per-class weighted sums, sums of
squares and counts of its non-NA rows, all one-hot matmuls in float64
(so counts of unit weights are exact). The host turns them into
smoothed, floored level probabilities and per-class means and standard
deviations. Scoring sums log-prior, gathered log level probabilities
and Gaussian log densities in float32, an NA predictor adding nothing,
and normalises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register

_HALF_LOG_2PI = 0.9189385332046727


class NaiveBayesModel(Model):
    algo_name = "naivebayes"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.priors: Optional[np.ndarray] = None          # (k,)
        self.cat_tables: List[np.ndarray] = []            # per cat: (k, card)
        self.num_means: Optional[np.ndarray] = None       # (k, n_num)
        self.num_sdevs: Optional[np.ndarray] = None       # (k, n_num)
        self.data_info: Optional[DataInfo] = None

    def _predict_raw(self, frame: Frame):
        di = self.data_info
        arrs = [c.data for c in di.cols(frame)]
        dev = arrs[0].device

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=dev)

        log_priors = f32(np.log(np.maximum(self.priors, 1e-30)))
        ncat = len(di.cat_names)
        ll = log_priors[None, :].expand(arrs[0].shape[0], -1)
        for i in range(ncat):
            codes = arrs[i].long()
            lt = f32(np.log(np.maximum(self.cat_tables[i], 1e-30))).T
            contrib = lt[torch.clamp_min(codes, 0)]       # (n, k)
            ll = ll + torch.where((codes >= 0)[:, None], contrib, 0.0)
        mu, sd = f32(self.num_means), f32(self.num_sdevs)
        for j in range(len(di.num_names)):
            x = arrs[ncat + j]
            lp = (-0.5 * ((x[:, None] - mu[None, :, j]) / sd[None, :, j]) ** 2
                  - torch.log(sd[None, :, j]) - _HALF_LOG_2PI)
            ll = ll + torch.where(torch.isnan(x)[:, None], 0.0, lp)
        ll = ll - ll.max(dim=1, keepdim=True).values
        probs = torch.exp(ll)
        return {"probs": probs / probs.sum(dim=1, keepdim=True)}


@register
class NaiveBayes(ModelBuilder):
    algo_name = "naivebayes"
    model_class = NaiveBayesModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "laplace": 0.0,
            "min_sdev": 0.001, "eps_sdev": 0.0,
            "min_prob": 0.001, "eps_prob": 0.0,
            "compute_metrics": True,
        })
        return p

    def _fit(self, train: Frame) -> NaiveBayesModel:
        p = self.params
        resp = p["response_column"]
        y_col = train.col(resp)
        if not y_col.is_categorical:
            raise ValueError("naivebayes requires a categorical response")
        k = y_col.cardinality
        di = DataInfo(train, response=resp,
                      ignored=p.get("ignored_columns") or (),
                      weights=p.get("weights_column"),
                      standardize=False, use_all_factor_levels=True)
        arrs = [c.data for c in di.cols(train)]
        y = y_col.data
        w_user = (train.col(p["weights_column"]).data
                  if p.get("weights_column") else None)
        ncat = len(di.cat_names)
        laplace = float(p.get("laplace", 0.0))

        # the one pass: (k,) priors, (k, card) level counts, per numeric
        # (k,) sums, sums of squares and counts of its non-NA rows
        w = DataInfo.response_weight(y, w_user).double()
        Y = torch.nn.functional.one_hot(torch.clamp_min(y.long(), 0),
                                        k).double() * w[:, None]
        priors = Y.sum(dim=0).cpu().numpy()
        tables = []
        for i in range(ncat):
            codes = arrs[i].long()
            C = torch.nn.functional.one_hot(torch.clamp_min(codes, 0),
                                            max(di.cards[i], 1)).double()
            tables.append(((Y * (codes >= 0)[:, None]).T @ C).cpu().numpy())
        sums, sqs, cnts = [], [], []
        for j in range(len(di.num_names)):
            x = arrs[ncat + j]
            ok = ~torch.isnan(x)
            xv = torch.where(ok, x, 0.0)
            # a bf16 column squares in bf16: the reference's matmul takes
            # the bf16 product as its operand
            sq = ((xv * xv).double() if xv.dtype == torch.bfloat16
                  else xv.double() * xv.double())
            xv = xv.double()
            Yv = Y * ok[:, None]
            sums.append((Yv.T @ xv).cpu().numpy())
            sqs.append((Yv.T @ sq).cpu().numpy())
            cnts.append(Yv.sum(dim=0).cpu().numpy())

        model = NaiveBayesModel(parms=dict(p))
        self._init_output(model, train)
        model.data_info = di
        min_sdev = max(float(p.get("min_sdev", 0.001)), 1e-10)
        eps_sdev = float(p.get("eps_sdev", 0.0) or 0.0)
        min_prob = max(float(p.get("min_prob", 0.001)), 1e-30)
        eps_prob = float(p.get("eps_prob", 0.0) or 0.0)
        cat_tables = []
        for t in tables:
            t = t + laplace
            t = t / np.maximum(t.sum(axis=1, keepdims=True), 1e-30)
            # a probability at or below eps_prob (a level never seen with
            # a class, at the default 0) becomes min_prob, so one unseen
            # level cannot veto a class
            cat_tables.append(np.where(t <= max(eps_prob, 1e-30), min_prob,
                                       t))
        nn = len(di.num_names)
        mu, sd = np.zeros((k, nn)), np.ones((k, nn))
        for j in range(nn):
            c = np.maximum(cnts[j], 1e-30)
            m = sums[j] / c
            s = np.sqrt(np.maximum(sqs[j] / c - m * m, 0.0))
            s = np.where(s <= eps_sdev, min_sdev, s)
            mu[:, j], sd[:, j] = m, np.maximum(s, min_sdev)
        model.num_means, model.num_sdevs = mu, sd
        model.cat_tables = cat_tables
        model.priors = priors / max(priors.sum(), 1e-30)
        return model
