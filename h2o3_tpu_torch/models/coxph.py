"""CoxPH: proportional-hazards regression by Newton's method on the
partial log-likelihood, Efron or Breslow ties, strata and left
truncation (counterpart of h2o3_tpu/models/coxph.py:
`CoxPHModel._predict_raw` :42, `_fit` :89, the risk-set layout :118-160,
`neg_loglik` :178, the Newton loop :205-229, the baseline hazard
:250-270, `_concordance` :275).

The host sorts the rows by (stratum, stop time) once and lays out the
tied-time groups, each event's rank within its group and each group's
stratum end. The partial likelihood is then a reverse cumulative sum of
the risk weights gathered at group starts (minus later strata's, and
with a start column minus the rows not yet entered), Efron's tied-event
correction a segment sum, all float32 on the device. Its gradient and
Hessian come from torch.func (`grad`, `hessian`), as the reference
takes jax.grad and jax.hessian of the same function. Each Newton step
solves H d = g on the device and halves d until the likelihood does
not worsen; the loop ends when the likelihood's relative change is
below 10^-lre_min. Concordance (Harrell's C on a seeded 4000-row
subsample) and the Breslow baseline hazard are host numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register


class CoxPHModel(Model):
    algo_name = "coxph"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.coefficients: Dict[str, float] = {}
        self.beta: Optional[np.ndarray] = None
        self.data_info: Optional[DataInfo] = None
        self.loglik: float = float("nan")
        self.loglik_null: float = float("nan")
        self.concordance: float = float("nan")
        self.iterations: int = 0
        self.baseline_hazard: Optional[np.ndarray] = None   # (times, hazard)
        self.strata: Optional[dict] = None     # stratify_by columns/domains

    def _predict_raw(self, frame: Frame):
        di = self.data_info
        X = di.expand(*(c.data for c in di.cols(frame)))
        beta = torch.as_tensor(self.beta, dtype=torch.float32,
                               device=X.device)
        return {"value": X @ beta}     # the centered linear predictor

    def _make_metrics(self, frame: Frame, raw, extra_weight=None):
        mm = M.ModelMetricsRegression()
        mm.description = (f"CoxPH loglik={self.loglik:.4f} "
                          f"concordance={self.concordance:.4f}")
        return mm


@register
class CoxPH(ModelBuilder):
    algo_name = "coxph"
    model_class = CoxPHModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "start_column": None,
            "stop_column": None,       # event time (required)
            "ties": "efron",           # efron | breslow
            "stratify_by": None,       # categorical columns
            "max_iterations": 20,
            "lre_min": 9.0,            # -log10 of the relative tolerance
        })
        return p

    def _fit(self, train: Frame) -> CoxPHModel:
        p = self.params
        event_col = p["response_column"]
        stop_col = p.get("stop_column")
        if not stop_col:
            raise ValueError("coxph requires stop_column (event time)")
        ties = (p.get("ties") or "efron").lower()
        if ties not in ("efron", "breslow"):
            raise ValueError(f"unknown ties {ties!r}")
        start_col = p.get("start_column")
        strat_cols = list(p.get("stratify_by") or [])
        if start_col and strat_cols:
            raise NotImplementedError(
                "start_column with stratify_by is not supported yet")
        ignore = (list(p.get("ignored_columns") or ()) + [stop_col]
                  + strat_cols + ([start_col] if start_col else []))
        di = DataInfo(train, response=event_col, ignored=ignore,
                      weights=p.get("weights_column"),
                      standardize=True, use_all_factor_levels=False)
        n = train.nrows
        times = train.col(stop_col).to_numpy().astype(np.float64)
        events = (train.col(event_col).to_numpy().astype(np.float64)
                  > 0).astype(np.float64)

        # strata: each has its own risk sets and baseline hazard; rows
        # sort by (stratum, time) so a stratum is contiguous
        strat_id = np.zeros(n, np.int64)
        strat_domains = []
        for cn in strat_cols:
            c = train.col(cn)
            if not c.is_categorical:
                raise ValueError(f"stratify_by column {cn!r} must be "
                                 "categorical")
            codes = np.maximum(c.to_numpy().astype(np.int64), 0)
            strat_id = strat_id * max(len(c.domain or []), 1) + codes
            strat_domains.append((cn, list(c.domain or [])))
        if strat_cols:
            _, strat_id = np.unique(strat_id, return_inverse=True)
        order = np.lexsort((times, strat_id))

        st, se, ss = times[order], events[order], strat_id[order]
        # tied-time groups (stratum, time); a risk set starts at its
        # group's first row
        _, group_start_idx, group_ids = np.unique(
            np.stack([ss, st]), axis=1, return_index=True,
            return_inverse=True)
        group_ids = group_ids.reshape(-1)
        ev_rows = np.nonzero(se > 0)[0]
        ev_gid = group_ids[ev_rows]
        d_per_group = np.bincount(ev_gid, minlength=group_ids.max() + 1)
        # each event's rank within its tied group
        ranks = np.zeros(len(ev_rows), np.int64)
        seen: Dict[int, int] = {}
        for i, g in enumerate(ev_gid):
            ranks[i] = seen.get(g, 0)
            seen[g] = ranks[i] + 1
        strat_end_row = np.searchsorted(ss, ss[group_start_idx],
                                        side="right")

        X = di.expand(*(c.data for c in di.cols(train)))
        dev = X.device

        def on_dev(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        Xs = X[on_dev(order)]
        n_groups = int(group_ids.max()) + 1
        gs, gend = on_dev(group_start_idx), on_dev(strat_end_row)
        ev_idx, ev_g = on_dev(ev_rows), on_dev(ev_gid)
        frac = on_dev(ranks / np.maximum(d_per_group[ev_gid], 1),
                      torch.float32)
        # left truncation: a row is at risk only from its start time, so
        # S0(t) = Σ r[stop ≥ t] − Σ r[start ≥ t]
        start_perm = late_pos = None
        if start_col:
            starts = train.col(start_col).to_numpy().astype(
                np.float64)[order]
            start_perm = on_dev(np.argsort(starts, kind="stable"))
            late_pos = on_dev(np.searchsorted(
                np.sort(starts), st[group_start_idx], side="left"))
        w_user = np.ones(n)
        if p.get("weights_column"):
            w_user = np.nan_to_num(
                train.col(p["weights_column"]).to_numpy(), nan=0.0)
        ws = on_dev(w_user[order], torch.float32)
        zero = torch.zeros(1, dtype=torch.float32, device=dev)

        def rev_cumsum(v):
            return torch.cat([torch.flip(torch.cumsum(torch.flip(v, [0]), 0),
                                         [0]), zero])

        def neg_loglik(beta):
            eta = Xs @ beta
            r = ws * torch.exp(eta)
            cumpad = rev_cumsum(r)
            S0 = cumpad[gs] - cumpad[gend]
            if start_perm is not None:
                S0 = S0 - rev_cumsum(r[start_perm])[late_pos]
            if ties == "efron":
                s0d = torch.zeros(n_groups, dtype=r.dtype,
                                  device=dev).index_add(0, ev_g, r[ev_idx])
                D = S0[ev_g] - frac * s0d[ev_g]
            else:
                D = S0[ev_g]
            ll = (torch.sum(ws[ev_idx] * eta[ev_idx])
                  - torch.sum(ws[ev_idx] * torch.log(torch.clamp_min(D,
                                                                    1e-30))))
            return -ll

        grad = torch.func.grad(neg_loglik)
        hess = torch.func.hessian(neg_loglik)
        beta = torch.zeros(di.fullN, dtype=torch.float32, device=dev)
        ll0 = -float(neg_loglik(beta))
        prev = -ll0
        tol = 10.0 ** (-float(p.get("lre_min", 9.0)))
        eye = 1e-8 * torch.eye(di.fullN, dtype=torch.float32, device=dev)
        it = 0
        for it in range(1, int(p.get("max_iterations", 20)) + 1):
            step = torch.linalg.solve(hess(beta) + eye, grad(beta))
            # halve the step while the likelihood gets worse
            for _ in range(10):
                cand = beta - step
                cur = float(neg_loglik(cand))
                if cur <= prev + 1e-12:
                    break
                step = step * 0.5
            beta = cand
            done = abs(prev - cur) <= tol * (abs(prev) + 1e-30)
            prev = cur
            if done:
                break
            if self.job:
                self.job.update(progress=it / int(p.get("max_iterations", 20)),
                                msg=f"newton {it}")

        model = CoxPHModel(parms=dict(p))
        self._init_output(model, train)
        model._output.model_category = ModelCategory.CoxPH
        model._output.names = [c for c in model._output.names
                               if c != stop_col]
        model.data_info = di
        model.iterations = it
        model.beta = beta.cpu().numpy().astype(np.float64)
        # the coefficients on the columns' own scale
        raw_beta = model.beta.copy()
        for j in range(len(di.num_names)):
            raw_beta[di.num_offset + j] /= max(di.num_sigmas[j], 1e-12)
        model.coefficients = {nm: float(raw_beta[j])
                              for j, nm in enumerate(di.coef_names())}
        model.loglik = -prev
        model.loglik_null = ll0
        eta_s = (Xs @ beta).cpu().numpy().astype(np.float64)
        model.concordance = _concordance(st, se, eta_s,
                                         strata=ss if strat_cols else None)
        # Breslow's cumulative baseline hazard at the event times, per
        # stratum
        r = w_user[order].astype(np.float32).astype(np.float64) \
            * np.exp(eta_s)
        cumpad_h = np.append(np.cumsum(r[::-1])[::-1], 0.0)
        S0 = cumpad_h[group_start_idx] - cumpad_h[strat_end_row]
        ev_groups = np.unique(ev_gid)
        t_ev = st[group_start_idx[ev_groups]]
        s_ev = ss[group_start_idx[ev_groups]]
        haz = d_per_group[ev_groups] / np.maximum(S0[ev_groups], 1e-30)
        cumhaz = np.zeros_like(haz, np.float64)
        for s in np.unique(s_ev):
            m = s_ev == s
            cumhaz[m] = np.cumsum(haz[m])
        if strat_cols:
            model.baseline_hazard = np.column_stack([s_ev, t_ev, cumhaz])
            model.strata = {"columns": [c for c, _ in strat_domains],
                            "domains": {c: d for c, d in strat_domains}}
        else:
            model.baseline_hazard = np.column_stack([t_ev, cumhaz])
        return model


def _concordance(times: np.ndarray, events: np.ndarray, eta: np.ndarray,
                 strata: np.ndarray = None) -> float:
    """Harrell's C, P(eta_i > eta_j | t_i < t_j, event_i), over the pairs
    of a seeded 4000-row subsample; with strata only pairs within a
    stratum count."""
    n = len(times)
    if n > 4000:
        idx = np.random.default_rng(0).choice(n, 4000, replace=False)
        times, events, eta = times[idx], events[idx], eta[idx]
        strata = strata[idx] if strata is not None else None
    usable = events[:, None].astype(bool) & (times[:, None] < times[None, :])
    if strata is not None:
        usable &= strata[:, None] == strata[None, :]
    d = eta[:, None] - eta[None, :]
    conc = np.sum(usable & (d > 0))
    disc = np.sum(usable & (d < 0))
    tied = np.sum(usable & (d == 0))
    tot = conc + disc + tied
    return float((conc + 0.5 * tied) / tot) if tot else float("nan")
