"""RuleFit: tree-ensemble rules, then a lasso GLM (counterpart of
h2o3_tpu/models/rulefit.py: `_leaf_rules` :29, `RuleFitModel` :60 with
`_rule_frame` :70, `RuleFit._fit` :114).

One DRF (or GBM) per rule depth in [min_rule_length, max_rule_length]
grows the rules: every reachable leaf of every tree is a rule, the
conjunction of the splits on its path. A rule's feature is 1 on the rows
that land in its leaf, read from the forest's leaf traversal
(CompressedForest.leaf_index), so no predicate is evaluated. With
`model_type` "linear" or "rules_and_linear" the numeric predictors join
as `linear.<name>`. A lasso GLM (alpha 1) with lambda search (20
lambdas), or at a given lambda, fits the rule frame, and the rule table
is sorted by |coefficient|. The trees train through the port's tree
builders, so the histogram kernel runs on this path.
"""

from __future__ import annotations

from typing import List, Tuple

from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register
from h2o3_tpu_torch.models.tree.drf import DRF
from h2o3_tpu_torch.models.tree.gbm import GBM


def leaf_rules(forest, spec, names: List[str]) -> List[Tuple[int, int, str]]:
    """(tree, leaf node, description) of every reachable leaf, by a
    depth-first walk of each tree's host arrays."""
    rules = []
    T = forest.feat.shape[0]
    for t in range(T):
        stack = [(0, [])]
        while stack:
            node, conds = stack.pop()
            f = int(forest.feat[t, node])
            if f < 0:
                rules.append((t, node, " & ".join(conds) if conds
                              else "(root)"))
                continue
            name = names[f] if f < len(names) else f"f{f}"
            if int(forest.cat_split[t, node]) >= 0:
                desc_l, desc_r = f"{name} in left-set", f"{name} in right-set"
            else:
                thr = spec.threshold_value(f, int(forest.thresh_bin[t, node]))
                desc_l, desc_r = f"{name} <= {thr:.6g}", f"{name} > {thr:.6g}"
            stack.append((int(forest.left[t, node]), conds + [desc_l]))
            stack.append((int(forest.right[t, node]), conds + [desc_r]))
    return rules


class RuleFitModel(Model):
    algo_name = "rulefit"

    def __init__(self, parms=None):
        super().__init__(parms=parms)
        self.tree_models: List = []          # the rule generators
        self.glm_model = None
        self.rules: List[dict] = []          # the rule table
        self.linear_names: List[str] = []

    def _rule_frame(self, frame: Frame) -> Frame:
        """Rows x (rule features, linear terms) from each generator's
        leaf of every row."""
        out = Frame()
        n = frame.nrows
        for mi, tm in enumerate(self.tree_models):
            leaves = tm.forest.leaf_index(tm.spec.bin_columns(
                tm.adapt_test(frame)))                       # (N, T)
            for r in self.rules:
                if r["model"] == mi:
                    feat = (leaves[:, r["tree"]] == r["node"]).float()
                    out.add(r["name"], Column(feat, T_NUM, n))
        for nm in self.linear_names:
            out.add(f"linear.{nm}", frame.col(nm))
        return out

    def adapt_test(self, test: Frame) -> Frame:
        return self.glm_model.adapt_test(self._rule_frame(test))

    def _predict_raw(self, frame: Frame):
        return self.glm_model._predict_raw(frame)     # already adapted

    def _make_metrics(self, frame: Frame, raw, extra_weight=None):
        return self.glm_model._make_metrics(frame, raw, extra_weight)

    def rule_importance(self) -> List[dict]:
        return self.rules


@register
class RuleFit(ModelBuilder):
    algo_name = "rulefit"
    model_class = RuleFitModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "algorithm": "DRF",          # rule generator: DRF | GBM
            "min_rule_length": 3,
            "max_rule_length": 3,
            "rule_generation_ntrees": 50,
            "model_type": "rules_and_linear",   # rules | linear | both
            "lambda_": None,
            "distribution": "AUTO",
        })
        return p

    def _fit(self, train: Frame) -> RuleFitModel:
        p = self.params
        resp = p["response_column"]
        model_type = (p.get("model_type") or "rules_and_linear").lower()
        seed = self._seed()
        model = RuleFitModel(parms=dict(p))
        self._init_output(model, train)

        # 1. rules: one ensemble per depth in [min, max]
        rules: List[dict] = []
        if model_type != "linear":
            lo = int(p.get("min_rule_length", 3))
            hi = int(p.get("max_rule_length", 3))
            depths = list(range(lo, hi + 1)) or [3]
            per = max(int(p.get("rule_generation_ntrees", 50))
                      // len(depths), 1)
            gen_cls = GBM if (p.get("algorithm") or "DRF").upper() == "GBM" \
                else DRF
            for di_, depth in enumerate(depths):
                tm = gen_cls(ntrees=per, max_depth=depth,
                             seed=seed + di_).train(y=resp,
                                                    training_frame=train)
                mi = len(model.tree_models)
                model.tree_models.append(tm)
                for t, node, desc in leaf_rules(tm.forest, tm.spec,
                                                tm._output.names):
                    rules.append({"model": mi, "tree": t, "node": node,
                                  "name": f"M{mi}T{t}N{node}", "rule": desc})
        model.rules = rules

        # 2. linear terms
        if model_type != "rules":
            model.linear_names = [nm for nm in model._output.names
                                  if train.col(nm).is_numeric]

        # 3. the lasso GLM on the rule frame
        rf = model._rule_frame(train)
        rf.add(resp, train.col(resp))
        y_col = train.col(resp)
        fam = ("binomial" if (y_col.is_categorical
                              and y_col.cardinality == 2)
               else "multinomial" if y_col.is_categorical else "gaussian")
        lam = p.get("lambda_")
        if lam is None:
            glm = GLM(family=fam, alpha=1.0, lambda_search=True,
                      nlambdas=20, seed=seed)
        else:
            glm = GLM(family=fam, alpha=1.0, lambda_=float(lam), seed=seed)
        model.glm_model = glm.train(y=resp, training_frame=rf)

        # 4. the rule table: coefficient, sorted by |coefficient|
        coefs = model.glm_model.coef()
        for r in rules:
            r["coefficient"] = 0.0
            for cn, cv in coefs.items():
                if cn == r["name"] or cn.startswith(r["name"] + "."):
                    r["coefficient"] = float(cv)
                    break
        model.rules = sorted(rules, key=lambda r: -abs(r["coefficient"]))
        model._output.model_category = \
            model.glm_model._output.model_category
        model._output.response_domain = \
            model.glm_model._output.response_domain
        return model
