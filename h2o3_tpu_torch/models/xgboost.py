"""XGBoost-compatible booster (counterpart of h2o3_tpu/models/xgboost.py:
`_ALIASES` :29, `XGBoost.default_params` :53, `translate_param` :87,
`_fit` :91, `_fit_gblinear` :107, `_fit_single_dart` :143 as the fit loop's `_tree_margin`
and `_add_tree` hooks, `_leaf_den_offset` :283,
`_leaf_gamma` :287; dart refuses a checkpoint :161).

The booster is the port's GBM engine (the same histogram tree grower,
so the same hand-written kernel on the card) under XGBoost's parameter
names and defaults: eta 0.3, depth 6, 256 bins (257 with the NA bin,
so an int16 bin matrix), min_child_weight 1, gamma 0. Leaves are
XGBoost's G / (H + lambda), with alpha soft-thresholding G. `booster=
"dart"` drops a random subset of the earlier trees each iteration
(normalize_type "tree"). `booster="gblinear"` trains the port's GLM
(`_fit_gblinear`, xgboost.py:107-130): the limit of linear boosting is
the elastic-net solution, with reg_alpha and reg_lambda mapped onto
alpha and a per-row lambda.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.models.model_builder import register
from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel


class XGBoostModel(GBMModel):
    algo_name = "xgboost"


# xgboost parameter name -> shared-tree parameter name
_ALIASES = {
    "eta": "learn_rate",
    "learn_rate": "learn_rate",
    "max_depth": "max_depth",
    "ntrees": "ntrees",
    "n_estimators": "ntrees",
    "subsample": "sample_rate",
    "sample_rate": "sample_rate",
    "colsample_bytree": "col_sample_rate_per_tree",
    "col_sample_rate_per_tree": "col_sample_rate_per_tree",
    "colsample_bylevel": "col_sample_rate",
    "col_sample_rate": "col_sample_rate",
    "min_child_weight": "min_rows",
    "min_rows": "min_rows",
    "max_bins": "nbins",
    "gamma": "min_split_improvement",
    "min_split_improvement": "min_split_improvement",
}


@register
class XGBoost(GBM):
    algo_name = "xgboost"
    row_sharded = True
    model_class = XGBoostModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "reg_lambda": 1.0,
            "reg_alpha": 0.0,
            "booster": "gbtree",          # gbtree | dart | gblinear
            "rate_drop": 0.0,             # dart: per-tree dropout chance
            "skip_drop": 0.0,             # dart: chance of no dropout
            "tree_method": "hist",
            # XGBoost's defaults, not GBM's
            "learn_rate": 0.3,
            "min_rows": 1.0,
            "max_depth": 6,
            "sample_rate": 1.0,
            "col_sample_rate_per_tree": 1.0,
            "nbins": 256,
            "min_split_improvement": 0.0,
        })
        return p

    def __init__(self, **params):
        super().__init__(**{_ALIASES.get(k, k): v for k, v in params.items()})

    @classmethod
    def translate_param(cls, name: str) -> str:
        return _ALIASES.get(name, name)

    def _booster(self) -> str:
        return (self.params.get("booster") or "gbtree").lower()

    def _fit(self, train):
        booster = self._booster()
        if booster not in ("gbtree", "dart", "gblinear"):
            raise ValueError(f"unknown booster {booster!r} "
                             "(gbtree | dart | gblinear)")
        if booster == "dart":
            resp = train.col(self.params["response_column"])
            if resp.is_categorical and len(resp.domain or []) > 2:
                raise ValueError("booster='dart' supports binomial/"
                                 "regression responses only")
        if booster == "gblinear":
            return self._fit_gblinear(train)
        try:
            return super()._fit(train)
        finally:
            self._dart = None         # dart's per-tree margins

    def _fit_gblinear(self, train):
        """booster='gblinear': the elastic-net GLM with alpha =
        reg_alpha / (reg_alpha + reg_lambda) and lambda = (reg_alpha +
        reg_lambda) / rows."""
        from h2o3_tpu_torch.models.glm import GLM

        ra = float(self.params.get("reg_alpha", 0.0) or 0.0)
        rl = float(self.params.get("reg_lambda", 1.0) or 0.0)
        tot = ra + rl
        resp = train.col(self.params["response_column"])
        fam = ("binomial" if (resp.is_categorical
                              and len(resp.domain or []) == 2)
               else "multinomial" if resp.is_categorical else "gaussian")
        glm = GLM(family=fam, alpha=(ra / tot) if tot > 0 else 0.0,
                  lambda_=tot / max(train.nrows, 1), seed=self._seed(),
                  response_column=self.params["response_column"],
                  weights_column=self.params.get("weights_column"),
                  offset_column=self.params.get("offset_column"),
                  ignored_columns=self.params.get("ignored_columns") or [])
        model = glm._fit(train)
        model._parms["booster"] = "gblinear"
        return model

    def _ckpt_start(self, ntrees: int, per_iter: int = 1) -> int:
        done = super()._ckpt_start(ntrees, per_iter)
        if done and self._booster() == "dart":
            raise ValueError("booster='dart' does not support checkpoints")
        return done

    def _job_ckpt_every(self) -> int:
        # dart's dropped-tree margins are not in the saved loop state (the
        # reference's dart loop saves none either), so dart never saves
        if self._booster() == "dart":
            return 0
        return super()._job_ckpt_every()

    def _tree_margin(self, rng, t, f):
        """booster='dart' (XGBoost's DartBooster, normalize_type 'tree'):
        each iteration drops a random subset D of the existing trees
        (drawn before the column masks, as the reference draws it) and
        grows the new tree against the margin without them, shrunk by
        lr/(|D|+lr). Per-tree contributions stay on the device, so the
        drop is arithmetic, with no re-traversal."""
        if self._booster() != "dart":
            return super()._tree_margin(rng, t, f)
        if t == 0:
            self._dart = {"contribs": [], "vcontribs": [], "vbase": None}
        st = self._dart
        rate_drop = float(self.params.get("rate_drop", 0.0) or 0.0)
        skip_drop = float(self.params.get("skip_drop", 0.0) or 0.0)
        drop = []
        if t > 0 and rate_drop > 0 and rng.random() >= skip_drop:
            drop = [i for i in range(t) if rng.random() < rate_drop]
        f_used = f
        for d in drop:
            f_used = f_used - st["contribs"][d]
        k = len(drop)
        lr_t = float(self._tree_lr(t))
        st["drop"], st["factor_old"] = drop, (k / (k + lr_t) if k else 1.0)
        return f_used, (lr_t / (k + lr_t) if k else lr_t), {"dropped": k}

    def _add_tree(self, f_used, f_valid, contrib, vcontrib, leaf_vals):
        """dart: the dropped trees come back scaled by |D|/(|D|+lr), on
        the training margin and mirrored on the validation margin."""
        if self._booster() != "dart":
            return super()._add_tree(f_used, f_valid, contrib, vcontrib,
                                     leaf_vals)
        st = self._dart
        if not st["contribs"]:
            st["vbase"] = f_valid
        drop, factor_old = st["drop"], st["factor_old"]
        if drop:
            f = f_used + contrib
            for d in drop:
                st["contribs"][d] = st["contribs"][d] * factor_old
                leaf_vals[d] = leaf_vals[d] * factor_old
                f = f + st["contribs"][d]
            if f_valid is not None:
                for d in drop:
                    st["vcontribs"][d] = st["vcontribs"][d] * factor_old
                f_valid = st["vbase"] + sum(st["vcontribs"]) + vcontrib
        else:
            f, f_valid = super()._add_tree(f_used, f_valid, contrib,
                                           vcontrib, leaf_vals)
        st["contribs"].append(contrib)
        if vcontrib is not None:
            st["vcontribs"].append(vcontrib)
        return f, f_valid

    def _leaf_den_offset(self) -> float:
        # XGBoost's leaf weight is G / (H + lambda)
        return float(self.params.get("reg_lambda", 1.0) or 0.0)

    def _leaf_gamma(self, ln, ld):
        # L1: soft-threshold the gradient sum by reg_alpha before dividing
        # by (H + lambda)
        alpha = float(self.params.get("reg_alpha", 0.0) or 0.0)
        num = (torch.sign(ln) * torch.clamp_min(torch.abs(ln) - alpha, 0.0)
               if alpha > 0 else ln)
        den = ld + self._leaf_den_offset()
        return torch.where(ld > 1e-12, num / torch.clamp_min(den, 1e-12),
                           0.0)
