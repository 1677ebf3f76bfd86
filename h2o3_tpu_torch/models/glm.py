"""GLM: generalized linear models (counterpart of h2o3_tpu/models/glm.py:
the families :43-180, links `_Link.of` :186, `_make_family` :213,
`_irls_fit` :233, `_multinomial_fit` :324, `_ordinal_class_probs` :366,
`_ordinal_fit` :387, `_ordinal_predict` :435, `_glm_predict` :443,
`_interaction_frame` :459, `GLMModel` :504, `GLM` :631 with `_fit` :668
and `_p_values` :928).

The design matrix (one-hot categoricals, standardised numerics,
DataInfo) is expanded once on the frame's device. IRLS: per step the
Gram XᵀWX and Xᵀz over the design with the intercept column last, then
a ridge on the non-intercept terms and a Cholesky solve with a jitter
scaled to the Gram's trace, or ADMM (rho 1, 50 sweeps, cached factor)
for L1 and non_negative, all in float32 as in the reference. The
reference forces full float32 products for the Gram because the
Cholesky and ADMM need them on collinear designs; the port sums the
Gram and Xᵀz in float64 and rounds them to float32 (`_gram`): on the
card cuBLAS's float32 sum of a rank-deficient rule design's Gram (200k
rows, 409 columns, largest eigenvalue 1.6e6) came out indefinite by
-14.7, so G + I had no factor (ROADMAP C10). A failed Cholesky gives
NaN, as jax.scipy's cho_factor does, instead of raising. Each step's
convergence test is one host sync. Multinomial and ordinal fits run
full-batch L-BFGS to optax's formulas (optim/lbfgs.py) on the softmax
and the proportional-odds likelihoods. p-values come
from the information matrix in float64 on the host, the normal tail
through math.erfc.

Not ported here: durable IRLS chunks and job progress (ROADMAP A14) and
the Rapids munge-to-score splice (`pipeline.try_glm_raw`, A11/A13);
predictions take the staged adapt -> expand path the reference falls
back to.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.distribution import get_distribution
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder
from h2o3_tpu_torch.optim import lbfgs

EPS = 1e-10
BINOMIALS = ("binomial", "quasibinomial", "fractionalbinomial")


# ---------------------------------------------------------------------------
# families (glm.py:43-180) and links (glm.py:184-210)
# ---------------------------------------------------------------------------

class _Family:
    name = "gaussian"
    default_link = "identity"

    def variance(self, mu):
        return torch.ones_like(mu)

    def deviance(self, w, y, mu):
        return w * (y - mu) ** 2

    def init_mu(self, y, w):
        return _wmean(y, w).expand(y.shape)


def _wmean(y, w):
    return torch.sum(w * y) / torch.clamp_min(torch.sum(w), EPS)


class _Gaussian(_Family):
    pass


class _Binomial(_Family):
    name = "binomial"
    default_link = "logit"

    def variance(self, mu):
        return mu * (1 - mu)

    def deviance(self, w, y, mu):
        mu = torch.clamp(mu, EPS, 1 - EPS)
        return -2 * w * (y * torch.log(mu) + (1 - y) * torch.log1p(-mu))

    def init_mu(self, y, w):
        return torch.clamp(_wmean(y, w), 0.01, 0.99).expand(y.shape)


class _Quasibinomial(_Binomial):
    name = "quasibinomial"


class _FractionalBinomial(_Binomial):
    name = "fractionalbinomial"


class _Poisson(_Family):
    name = "poisson"
    default_link = "log"

    def variance(self, mu):
        return torch.clamp_min(mu, EPS)

    def deviance(self, w, y, mu):
        mu = torch.clamp_min(mu, EPS)
        ylogy = torch.where(y > 0, y * torch.log(y / mu), 0.0)
        return 2 * w * (ylogy - (y - mu))

    def init_mu(self, y, w):
        return torch.clamp_min(_wmean(y, w), 0.1).expand(y.shape)


class _Gamma(_Family):
    name = "gamma"
    default_link = "log"      # the reference's choice (inverse in H2O)

    def variance(self, mu):
        return torch.clamp_min(mu, EPS) ** 2

    def deviance(self, w, y, mu):
        mu = torch.clamp_min(mu, EPS)
        yy = torch.clamp_min(y, EPS)
        return 2 * w * (-torch.log(yy / mu) + (yy - mu) / mu)

    init_mu = _Poisson.init_mu


class _Tweedie(_Family):
    name = "tweedie"
    default_link = "tweedie"

    def __init__(self, var_power=1.5):
        self.var_power = float(var_power)

    def variance(self, mu):
        return torch.clamp_min(mu, EPS) ** self.var_power

    def deviance(self, w, y, mu):
        p = self.var_power
        mu = torch.clamp_min(mu, EPS)
        y0 = torch.clamp_min(y, 0.0)
        return 2 * w * (y0 ** (2 - p) / ((1 - p) * (2 - p))
                        - y * mu ** (1 - p) / (1 - p) + mu ** (2 - p) / (2 - p))

    init_mu = _Poisson.init_mu


class _NegativeBinomial(_Family):
    name = "negativebinomial"
    default_link = "log"

    def __init__(self, theta=1.0):
        self.theta = float(theta)     # inverse dispersion

    def variance(self, mu):
        return mu + self.theta * mu * mu

    def deviance(self, w, y, mu):
        t = 1.0 / self.theta
        mu = torch.clamp_min(mu, EPS)
        ylogy = torch.where(y > 0, y * torch.log(y / mu), 0.0)
        return 2 * w * (ylogy - (y + t) * torch.log((y + t) / (mu + t)))

    init_mu = _Poisson.init_mu


def _nonzero(v):
    return torch.where(torch.abs(v) < EPS, EPS, v)


def link_fns(name: str, tweedie_link_power: float = 0.0):
    """(link, inverse link, d link / d mu) by name (glm.py:186)."""
    if name == "identity":
        return (lambda mu: mu, lambda eta: eta, torch.ones_like)
    if name == "log":
        return (lambda mu: torch.log(torch.clamp_min(mu, EPS)),
                lambda eta: torch.exp(torch.clamp(eta, -30, 30)),
                lambda mu: 1.0 / torch.clamp_min(mu, EPS))
    if name == "logit":
        def logit(mu):
            m = torch.clamp(mu, EPS, 1 - EPS)
            return torch.log(m / (1 - m))
        return (logit, lambda eta: 1.0 / (1.0 + torch.exp(-eta)),
                lambda mu: 1.0 / torch.clamp_min(mu * (1 - mu), EPS))
    if name == "inverse":
        return (lambda mu: 1.0 / _nonzero(mu),
                lambda eta: 1.0 / _nonzero(eta),
                lambda mu: -1.0 / torch.clamp_min(mu * mu, EPS))
    if name == "tweedie":
        lp = tweedie_link_power
        if lp == 0.0:
            return link_fns("log")
        return (lambda mu: torch.clamp_min(mu, EPS) ** lp,
                lambda eta: torch.clamp_min(eta, EPS) ** (1.0 / lp),
                lambda mu: lp * torch.clamp_min(mu, EPS) ** (lp - 1))
    raise ValueError(f"unknown link {name}")


def make_family(name: str, params: dict) -> _Family:
    name = name.lower()
    if name == "tweedie":
        return _Tweedie(params.get("tweedie_variance_power", 1.5))
    if name == "negativebinomial":
        return _NegativeBinomial(params.get("theta", 1.0))
    m = {"gaussian": _Gaussian, "binomial": _Binomial,
         "quasibinomial": _Quasibinomial,
         "fractionalbinomial": _FractionalBinomial, "poisson": _Poisson,
         "gamma": _Gamma}
    if name not in m:
        raise ValueError(f"unknown GLM family {name!r}")
    return m[name]()


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def _with_intercept_column(X, value=1.0):
    ones = torch.full((X.shape[0], 1), value, dtype=X.dtype, device=X.device)
    return torch.cat([X, ones], dim=1)


def _gram(Xi, wls, z=None):
    """(XᵀWX, XᵀWz) summed in float64 and rounded to float32: the exact
    Gram rounded once, which stays positive semi-definite to float32
    rounding, where a float32 sum can lose it on a large rank-deficient
    design."""
    Xd = Xi.double()
    Xw = Xd * wls.double()[:, None]
    G = (Xd.T @ Xw).float()
    return G, (None if z is None else (Xw.T @ z.double()).float())


def _cho_factor(A):
    """Lower Cholesky factor and a flag that is False where the matrix
    was not positive definite (jax.scipy's factor is NaN there)."""
    L, info = torch.linalg.cholesky_ex(A)
    return L, info == 0


def _cho_solve(factor, b):
    L, ok = factor
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(ok, x, torch.nan)


def _irls_fit(X, y, w, offset, beta0, lam_l2, lam_l1, beta_eps, *,
              famname, linkname, max_iter, var_power=1.5, link_power=0.0,
              with_intercept=True, non_negative=False):
    """IRLS (glm.py:233): -> (beta (p+1,), iterations, deviance tensor).
    X is the expanded (N, p) design; the intercept is the last
    coefficient. With intercept=False the ones column is zeroed, so the
    jitter pins the intercept to 0. lam_l2 and lam_l1 are float32 values
    (host floats); the family takes only the Tweedie power here, so a
    negative binomial's IRLS weights use theta 1, as the reference's."""
    fam = make_family(famname, {"tweedie_variance_power": var_power})
    link, linkinv, dlink = link_fns(linkname, link_power)
    p = X.shape[1]
    Xi = _with_intercept_column(X, 1.0 if with_intercept else 0.0)
    pi = p + 1
    dev = X.device
    ridge = torch.cat([torch.ones(p), torch.zeros(1)]).to(dev)
    eye = torch.eye(pi, dtype=X.dtype, device=dev)
    use_admm = lam_l1 > 0 or non_negative

    def dev_of(beta):
        mu = linkinv(Xi @ beta + offset)
        return torch.sum(fam.deviance(w, y, mu))

    def admm_solve(G, q, l1, rho=1.0, sweeps=50):
        """min ½βᵀGβ - qᵀβ + l1·|β|₁ (β ≥ 0 too with non_negative; the
        intercept is neither penalised nor bounded), ADMM around the
        cached factor of G + ρI (glm.py:259)."""
        factor = _cho_factor(G + rho * eye)
        pen = torch.cat([torch.full((p,), l1), torch.zeros(1)]).to(dev)
        z = torch.zeros(pi, dtype=G.dtype, device=dev)
        u = torch.zeros(pi, dtype=G.dtype, device=dev)
        for _ in range(sweeps):
            b = _cho_solve(factor, q + rho * (z - u))
            z2 = torch.sign(b + u) * torch.clamp_min(
                torch.abs(b + u) - pen / rho, 0.0)
            if non_negative:
                z2 = torch.cat([torch.clamp_min(z2[:p], 0.0), z2[p:]])
            z, u = z2, u + b - z2
        return z

    def step(beta):
        eta = Xi @ beta + offset
        mu = linkinv(eta)
        gp = dlink(mu)
        wls = w / torch.clamp_min(fam.variance(mu) * gp * gp, EPS)
        z = (eta - offset) + (y - mu) * gp
        G, q = _gram(Xi, wls, z)
        Greg = G + lam_l2 * torch.diag(ridge)
        if use_admm:
            return admm_solve(Greg, q, lam_l1)
        # jitter scaled to the Gram: collinear designs stay solvable
        jitter = 1e-6 * (torch.trace(Greg) / pi + 1.0)
        return _cho_solve(_cho_factor(Greg + jitter * eye), q)

    mu0 = fam.init_mu(y, w)
    if bool((beta0 != 0).any()):
        beta = beta0
    else:
        beta = torch.zeros(pi, dtype=torch.float32, device=dev)
        if with_intercept:
            beta[p] = torch.mean(link(mu0))
    prev, it = beta + 1e3, 0
    while it < max_iter and float(torch.max(torch.abs(beta - prev))) \
            > beta_eps:
        prev, beta = beta, step(beta)
        it += 1
    return beta, it, dev_of(beta)


def _multinomial_fit(X, y, w, B0, lam_l2, *, max_iter):
    """Softmax regression by full-batch L-BFGS (glm.py:324): -> (B
    (p+1, K), iterations, the summed weighted NLL)."""
    Xi = _with_intercept_column(X)
    yi = y.long()[:, None]
    wsum = torch.clamp_min(torch.sum(w), EPS)

    def loss(B):
        logits = Xi @ B
        lse = torch.logsumexp(logits, dim=-1)
        nll = torch.sum(w * (lse - torch.gather(logits, 1, yi)[:, 0])) / wsum
        return nll + 0.5 * lam_l2 * torch.sum(B[:-1] ** 2) / wsum

    B, iters = lbfgs.minimize(lbfgs.value_and_grad(loss), B0, max_iter)
    return B, iters, loss(B) * wsum


def ordinal_class_probs(X, v):
    """(p coefficients, K-1 raw threshold parameters) -> (N, K) class
    probabilities; thresholds theta_0 + cumsum(softplus(d_j)) are
    ordered by construction (glm.py:366)."""
    p = X.shape[1]
    beta, traw = v[:p], v[p:]
    soft = torch.logaddexp(traw[1:], torch.zeros_like(traw[1:]))
    th = traw[0] + torch.cat([torch.zeros_like(traw[:1]),
                              torch.cumsum(soft, 0)])
    eta = X @ beta
    cum = torch.sigmoid(th[None, :] - eta[:, None])
    N = X.shape[0]
    cf = torch.cat([torch.zeros((N, 1), dtype=cum.dtype, device=cum.device),
                    cum, torch.ones((N, 1), dtype=cum.dtype,
                                    device=cum.device)], 1)
    return cf[:, 1:] - cf[:, :-1]


def _ordinal_fit(X, y, w, lam_l2, *, nclasses, max_iter):
    """Proportional-odds cumulative logit, P(y <= k) = sigmoid(theta_k -
    x·beta), by full-batch L-BFGS (glm.py:387)."""
    p = X.shape[1]
    yi = y.long()[:, None]
    wsum = torch.clamp_min(torch.sum(w), EPS)

    def loss(v):
        pk = ordinal_class_probs(X, v)
        picked = torch.clamp_min(torch.gather(pk, 1, yi)[:, 0], 1e-12)
        nll = -torch.sum(w * torch.log(picked)) / wsum
        return nll + 0.5 * lam_l2 * torch.sum(v[:p] ** 2) / wsum

    v0 = torch.zeros(p + nclasses - 1, dtype=torch.float32, device=X.device)
    v0[p] = -1.0        # spread the first threshold so classes separate
    v, iters = lbfgs.minimize(lbfgs.value_and_grad(loss), v0, max_iter)
    return v, iters, loss(v) * wsum


def glm_predict(X, beta, offset, *, linkname, link_power=0.0, nclasses=1):
    """Response-scale predictions (glm.py:443): softmax for K > 2, else
    the inverse link of the margin plus offset."""
    Xi = _with_intercept_column(X)
    if nclasses > 2:
        return torch.softmax(Xi @ beta, dim=-1)
    _, linkinv, _ = link_fns(linkname, link_power)
    return linkinv(Xi @ beta + offset)


# ---------------------------------------------------------------------------
# model + builder
# ---------------------------------------------------------------------------

def interaction_frame(frame: Frame, interactions, response=None) -> Frame:
    """The frame with pairwise interaction columns appended (glm.py:459):
    num x num the product; enum x num the numeric per level (0 off the
    level); enum x enum one indicator per level pair. An NA enum makes
    the row's interaction values NA."""
    cols = [c for c in interactions if c != response]
    missing = [c for c in cols if c not in frame]
    if missing:
        raise ValueError(f"interactions column(s) {missing} not in frame")
    out = Frame()
    for nm in frame.names:
        out.add(nm, frame.col(nm))
    n = frame.nrows
    for i in range(len(cols)):
        for j in range(i + 1, len(cols)):
            a, b = cols[i], cols[j]
            ca, cb = frame.col(a), frame.col(b)
            if ca.is_categorical and cb.is_categorical:
                na = (ca.data < 0) | (cb.data < 0)
                for la, lev_a in enumerate(ca.domain or []):
                    for lb, lev_b in enumerate(cb.domain or []):
                        v = ((ca.data == la) & (cb.data == lb)).float()
                        out.add(f"{a}_{lev_a}:{b}_{lev_b}",
                                Column(torch.where(na, torch.nan, v), T_NUM,
                                       n))
            elif ca.is_categorical or cb.is_categorical:
                cat, num = (ca, cb) if ca.is_categorical else (cb, ca)
                catn, numn = (a, b) if ca.is_categorical else (b, a)
                na = cat.data < 0
                for li, lev in enumerate(cat.domain or []):
                    v = torch.where(cat.data == li, num.data, 0.0)
                    out.add(f"{catn}_{lev}:{numn}",
                            Column(torch.where(na, torch.nan, v), T_NUM, n))
            else:
                out.add(f"{a}:{b}", Column(ca.data * cb.data, T_NUM, n))
    return out


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class GLMModel(Model):
    algo_name = "glm"

    def __init__(self, parms=None):
        super().__init__(parms=parms)
        self.beta: Optional[torch.Tensor] = None   # (p+1,) or (p+1, K)
        self.dinfo: Optional[DataInfo] = None
        self.linkname: str = "identity"
        self.link_power: float = 0.0
        self.null_deviance = float("nan")
        self.residual_deviance = float("nan")
        self.aic = float("nan")
        self.iterations = 0
        self.p_values: Optional[np.ndarray] = None
        self.std_errors: Optional[np.ndarray] = None

    def adapt_test(self, test: Frame) -> Frame:
        ints = self._parms.get("interactions")
        if ints:
            # interaction enums go onto the training domains first, so a
            # level missing from the test frame expands to zeros, not to
            # an NA-filled missing column
            pre = Frame()
            for nm in test.names:
                c = test.col(nm)
                if nm in ints:
                    c = self._remap_col(c, self._output.domains.get(nm))
                pre.add(nm, c)
            test = interaction_frame(pre, list(ints),
                                     self._output.response_name)
        return super().adapt_test(test)

    def _design(self, frame: Frame) -> torch.Tensor:
        return self.dinfo.expand(*(c.data for c in self.dinfo.cols(frame)))

    def _predict_raw(self, frame: Frame):
        X = self._design(frame)
        beta = self.beta.to(X.device)
        K = self._output.nclasses
        if K > 2:
            if self.linkname == "ordinal":
                probs = ordinal_class_probs(X, beta)
                return {"probs": torch.clamp_min(probs, 0.0)}
            return {"probs": glm_predict(X, beta, 0.0,
                                         linkname=self.linkname,
                                         nclasses=K)}
        offset = 0.0
        oc = self._parms.get("offset_column")
        if oc and oc in frame:
            offset = frame.col(oc).data
        mu = glm_predict(X, beta, offset, linkname=self.linkname,
                         link_power=self.link_power)
        if K == 2:
            return {"probs": torch.stack([1 - mu, mu], dim=-1)}
        return {"value": mu}

    def coef(self) -> Dict[str, float]:
        """De-standardised coefficients by expanded name, and Intercept
        (glm.py:574)."""
        if self.linkname == "ordinal":
            return self._coef_ordinal(destandardize=True)
        names = self.dinfo.coef_names() + ["Intercept"]
        b = _host(self.beta).astype(np.float64)
        if self.dinfo.standardize:
            b = b.copy()
            k = self.dinfo.num_offset
            s = np.asarray(self.dinfo.num_sigmas, np.float64)
            m = np.asarray(self.dinfo.num_means, np.float64)
            nn = len(self.dinfo.num_names)
            if nn:
                if b.ndim == 2:      # multinomial: a column per class
                    b[-1, :] -= (b[k:k + nn, :] * (m / s)[:, None]).sum(0)
                    b[k:k + nn, :] = b[k:k + nn, :] / s[:, None]
                else:
                    b[-1] -= float(np.sum(b[k:k + nn] * m / s))
                    b[k:k + nn] = b[k:k + nn] / s
        if b.ndim == 2:
            return {n: b[i].tolist() for i, n in enumerate(names)}
        return {n: float(b[i]) for i, n in enumerate(names)}

    def _coef_ordinal(self, destandardize: bool) -> Dict[str, float]:
        """Coefficients and the resolved thresholds theta_k (glm.py:598);
        de-standardising divides beta_j by sigma_j and shifts every
        theta by sum(beta_j mu_j / sigma_j)."""
        p = len(self.dinfo.coef_names())
        v = _host(self.beta).astype(np.float64)
        beta, traw = v[:p].copy(), v[p:]
        th = traw[0] + np.concatenate(
            [[0.0], np.cumsum(np.logaddexp(0.0, traw[1:]))])
        if destandardize and self.dinfo.standardize:
            k = self.dinfo.num_offset
            s = np.asarray(self.dinfo.num_sigmas, np.float64)
            m = np.asarray(self.dinfo.num_means, np.float64)
            nn = len(self.dinfo.num_names)
            if nn:
                th = th + float(np.sum(beta[k:k + nn] * m / s))
                beta[k:k + nn] = beta[k:k + nn] / s
        out = {n: float(beta[i])
               for i, n in enumerate(self.dinfo.coef_names())}
        for j, t in enumerate(th):
            out[f"theta_{j}"] = float(t)
        return out

    def coef_norm(self) -> Dict[str, float]:
        if self.linkname == "ordinal":
            return self._coef_ordinal(destandardize=False)
        names = self.dinfo.coef_names() + ["Intercept"]
        b = _host(self.beta).astype(np.float64)
        if b.ndim == 2:      # multinomial: a list per name, as coef()
            return {n: b[i].tolist() for i, n in enumerate(names)}
        return {n: float(b[i]) for i, n in enumerate(names)}


class GLM(ModelBuilder):
    algo_name = "glm"
    model_class = GLMModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "family": "AUTO", "link": "family_default", "solver": "AUTO",
            "alpha": None, "lambda_": None, "lambda_search": False,
            "nlambdas": 30, "lambda_min_ratio": 1e-4,
            "standardize": True, "intercept": True,
            "max_iterations": 50, "beta_epsilon": 1e-4,
            "tweedie_variance_power": 1.5, "tweedie_link_power": 0.0,
            "theta": 1.0, "missing_values_handling": "MeanImputation",
            "compute_p_values": False, "remove_collinear_columns": False,
            "interactions": None, "non_negative": False,
        })
        return p

    def _resolve_family(self, train: Frame) -> str:
        fam = (self.params.get("family") or "AUTO").lower()
        resp = train.col(self.params["response_column"])
        if fam == "auto":
            if resp.is_categorical:
                fam = ("binomial" if len(resp.domain or []) == 2
                       else "multinomial")
            else:
                fam = "gaussian"
        return fam

    def _fit(self, train: Frame) -> GLMModel:
        p = self.params
        ints = p.get("interactions")
        if ints:
            # interaction columns join the design before the output schema
            # is taken, so adapt_test re-expands test frames the same way
            train = interaction_frame(train, list(ints),
                                      p.get("response_column"))
        fam = self._resolve_family(train)
        resp = p["response_column"]
        y_col = train.col(resp)
        resp_dom = y_col.domain if y_col.is_categorical else None
        if fam in BINOMIALS and resp_dom is not None and len(resp_dom) > 2:
            raise ValueError(
                f"family={fam} requires a binary response; {resp!r} has "
                f"{len(resp_dom)} levels (use family='multinomial')")
        lam = p.get("lambda_")
        if isinstance(lam, (list, tuple)):
            lam = lam[0]
        if p.get("compute_p_values") and (p.get("lambda_search")
                                          or (lam or 0) != 0):
            # shrunken coefficients make the information-matrix standard
            # errors meaningless
            raise ValueError("compute_p_values requires lambda=0 and no "
                             "lambda_search")
        if fam == "ordinal" and (resp_dom is None or len(resp_dom) < 3):
            raise ValueError("family='ordinal' needs a categorical response "
                             "with at least 3 ordered levels")
        model = GLMModel(parms=dict(p))
        self._init_output(model, train)
        out = model._output
        if fam in ("multinomial", "ordinal"):
            out.model_category = ModelCategory.Multinomial
        elif fam in BINOMIALS:
            # a numeric 0/1 response is a 2-class classifier too
            out.model_category = ModelCategory.Binomial
            if out.response_domain is None:
                out.response_domain = ["0", "1"]
        # no intercept: every factor level, and the raw scale (centring
        # would pin the prediction at the feature means to linkinv(0))
        with_icpt = bool(p.get("intercept", True))
        dinfo = DataInfo(train, response=resp,
                         ignored=p.get("ignored_columns") or (),
                         weights=p.get("weights_column"),
                         offset=p.get("offset_column"),
                         standardize=(bool(p.get("standardize", True))
                                      and with_icpt),
                         use_all_factor_levels=not with_icpt)
        model.dinfo = dinfo
        arrays = tuple(c.data for c in dinfo.cols(train))
        X = dinfo.expand(*arrays)
        w_user = (train.col(p["weights_column"]).data
                  if p.get("weights_column") else None)
        wts = DataInfo.response_weight(y_col.data, w_user)
        if str(p.get("missing_values_handling", "")).lower() == "skip":
            wts = wts * (1.0 - dinfo.na_row_mask(*arrays))
        y = DataInfo.clean_response(y_col.data).float()
        offset = torch.zeros_like(y)
        if p.get("offset_column"):
            oc = train.col(p["offset_column"]).data.float()
            offset = torch.where(torch.isnan(oc), 0.0, oc)

        alpha = p.get("alpha")
        alpha = 0.5 if alpha is None else (
            alpha[0] if isinstance(alpha, (list, tuple)) else float(alpha))
        nobs = float(torch.sum(wts))
        max_iter = int(p["max_iterations"])

        if fam in ("ordinal", "multinomial"):
            if not with_icpt or bool(p.get("non_negative")):
                raise ValueError("intercept=False / non_negative are not "
                                 f"supported for family='{fam}'")
            if fam == "ordinal" and p.get("offset_column"):
                raise ValueError("offset_column is not supported for "
                                 "family='ordinal'")
            K = len(y_col.domain or [])
            l2 = _f32((0.0 if lam is None else float(lam))
                      * (1 - alpha) * nobs)
            if fam == "ordinal":
                beta, iters, dev = _ordinal_fit(X, y, wts, l2, nclasses=K,
                                                max_iter=max_iter)
            else:
                B0 = torch.zeros((dinfo.fullN + 1, K), dtype=torch.float32,
                                 device=X.device)
                beta, iters, dev = _multinomial_fit(X, y, wts, B0, l2,
                                                    max_iter=max_iter)
            model.beta = beta
            model.iterations = int(iters)
            model.residual_deviance = 2 * float(dev)
            model.linkname = fam
            return model

        linkname = p.get("link") or "family_default"
        if linkname in ("family_default", "AUTO"):
            linkname = make_family(fam, p).default_link
        model.linkname = linkname
        model.link_power = float(p.get("tweedie_link_power", 0.0))
        if lam is None and not p.get("lambda_search"):
            lam = 0.0 if p.get("compute_p_values") else 1e-5
        beta_eps = _f32(p.get("beta_epsilon", 1e-4))

        def fit_one(lam_val, beta_init):
            return _irls_fit(
                X, y, wts, offset, beta_init,
                _f32(float(lam_val) * (1 - alpha) * nobs),
                _f32(float(lam_val) * alpha * nobs), beta_eps,
                famname=fam, linkname=linkname, max_iter=max_iter,
                var_power=float(p["tweedie_variance_power"]),
                link_power=model.link_power, with_intercept=with_icpt,
                non_negative=bool(p.get("non_negative", False)))

        b0 = torch.zeros(dinfo.fullN + 1, dtype=torch.float32,
                         device=X.device)
        if p.get("lambda_search"):
            beta, dev, fitted, chosen = self._lambda_path(
                X, y, wts, nobs, alpha, fit_one, b0)
            model.iterations = fitted
            p["lambda_"] = float(chosen)
        else:
            beta, iters, dev = fit_one(lam, b0)
            dev = float(dev)
            model.iterations = int(iters)

        model.beta = beta
        model.residual_deviance = float(dev)
        # regression metrics report the family's deviance where the shared
        # Distribution has it (glm.py:903-908)
        tvp = float(p["tweedie_variance_power"])
        if fam in ("gaussian", "poisson", "gamma") or (
                fam == "tweedie" and 1.0 < tvp < 2.0):
            model._distribution = get_distribution(fam, tweedie_power=tvp)
        # null deviance: the intercept-only fit is the weighted mean for
        # every family here; without an intercept, linkinv(0)
        family = make_family(fam, p)
        if with_icpt:
            null_mu = _wmean(y, wts)
        else:
            _, linkinv, _ = link_fns(linkname, model.link_power)
            null_mu = linkinv(torch.zeros((), device=y.device))
        model.null_deviance = float(torch.sum(family.deviance(
            wts, y, null_mu.expand(y.shape))))
        rank = int(np.sum(np.abs(_host(beta)) > 1e-10))
        model.aic = model.residual_deviance + 2 * rank
        if p.get("compute_p_values") and (lam or 0) == 0:
            self._p_values(model, X, y, wts, offset, fam, linkname)
        return model

    def _lambda_path(self, X, y, wts, nobs, alpha, fit_one, b0):
        """Lambda search (glm.py:812-866): a geometric path down from
        lambda_max (the smallest lambda that zeroes every coefficient),
        warm-started; stops when the relative deviance gain stalls once
        the path explains any deviance, or at the wall-clock budget, and
        keeps the last fit that still improved. -> (beta, deviance, fits,
        chosen lambda)."""
        p = self.params
        ybar = float(torch.sum(wts * y) / nobs)
        _, g = _gram(X, wts, y - ybar)
        lam_max = float(torch.max(torch.abs(g))) / max(alpha, 1e-3) / nobs
        nl = int(p.get("nlambdas", 30))
        path = lam_max * np.power(float(p["lambda_min_ratio"]),
                                  np.linspace(0, 1, nl))
        beta, prev_dev, chosen = b0, np.inf, path[0]
        fitted, null_dev_est = 0, None
        for lv in path:
            beta_new, _, dev = fit_one(lv, beta)
            fitted += 1
            dev = float(dev)
            if null_dev_est is None:
                null_dev_est = dev      # at lambda_max every coef is 0
            started = dev < null_dev_est * 0.999
            if prev_dev < np.inf and started and dev > prev_dev * (1 - 1e-4):
                break       # the gain stalled: keep the previous fit
            beta, prev_dev, chosen = beta_new, dev, lv
            if self._out_of_time():
                break
        return beta, prev_dev, fitted, chosen

    def _p_values(self, model, X, y, wts, offset, fam, linkname):
        """Standard errors and z-test p-values from the unregularised
        information matrix (glm.py:928), inverted in float64 on the
        host; 2·(1 − Φ(|z|)) with Φ through math.erfc."""
        family = make_family(fam, self.params)
        _, linkinv, dlink = link_fns(linkname, model.link_power)
        Xi = _with_intercept_column(X)
        mu = linkinv(Xi @ model.beta + offset)
        gp = dlink(mu)
        wls = wts / torch.clamp_min(family.variance(mu) * gp * gp, EPS)
        G = _gram(Xi, wls)[0].double().cpu().numpy()
        try:
            cov = np.linalg.inv(G)
        except np.linalg.LinAlgError:
            return
        se = np.sqrt(np.maximum(np.diag(cov), 0))
        b = _host(model.beta).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            z = b / se
        model.std_errors = se
        model.p_values = np.array([2 * (1 - normal_cdf(abs(v))) for v in z])


def normal_cdf(x: float) -> float:
    """Φ(x) of the standard normal."""
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def _f32(v) -> float:
    """A host float rounded to float32, as the reference hands its
    scalars to the device."""
    return float(np.float32(v))
