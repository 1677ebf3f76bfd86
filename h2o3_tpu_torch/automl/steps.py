"""AutoML modeling-step registry: per-algo providers and exploitation
(counterpart of h2o3_tpu/automl/steps.py, copied whole: the providers
and their `GROUP_*` values, `REGISTRY` :150, `build_plan` :155,
`exploitation_steps` :173). For the same seed and include/exclude lists
the port draws the same plan as the reference, to the last float.

Reference: ai.h2o.automl.modeling.* (GBMStepsProvider etc.), one provider
per algo contributing `defaults` (priority group 1-5), `grids` (group 10)
and `exploitation` (group 60) steps, budgeted through WorkAllocations.
The exploitation phase refines the CURRENT best model of a family
(GBM lr-annealing, XGBoost lr-search in the reference) — steps are built
lazily against the live leaderboard, not a static list.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

# group ordering mirrors the reference's executionOrder: defaults run
# before grids, exploitation runs last on what the earlier phases found
GROUP_DEFAULTS = 1
GROUP_GRIDS = 10
GROUP_EXPLOITATION = 60


def step(name: str, algo: str, weight: int, group: int,
         **params) -> Dict[str, Any]:
    return {"name": name, "algo": algo, "weight": weight, "group": group,
            "params": params}


class StepsProvider:
    """One registered provider per algo (ModelingStepsProvider analog)."""

    algo: str = ""
    has_exploitation: bool = False   # provider contributes group-60 steps

    def defaults(self, ctx: Dict[str, Any]) -> List[Dict[str, Any]]:
        return []

    def grids(self, ctx: Dict[str, Any],
              rng: np.random.Generator) -> List[Dict[str, Any]]:
        return []

    def exploitation(self, ctx: Dict[str, Any],
                     best: Optional[Any]) -> List[Dict[str, Any]]:
        """Steps refining `best` (the family's current leaderboard top);
        empty when the family produced no model."""
        return []


class GLMSteps(StepsProvider):
    algo = "glm"

    def defaults(self, ctx):
        fam = "binomial" if ctx["classification"] else "gaussian"
        return [step("def_glm", "glm", 10, GROUP_DEFAULTS, family=fam,
                     alpha=0.5, lambda_search=True)]


class GBMSteps(StepsProvider):
    algo = "gbm"
    has_exploitation = True

    def defaults(self, ctx):
        return [
            step("def_gbm_1", "gbm", 10, GROUP_DEFAULTS, ntrees=50,
                 max_depth=6, learn_rate=0.1, sample_rate=0.8,
                 col_sample_rate_per_tree=0.8),
            step("def_gbm_2", "gbm", 10, GROUP_DEFAULTS, ntrees=100,
                 max_depth=4, learn_rate=0.05, sample_rate=0.9),
        ]

    def grids(self, ctx, rng):
        out = []
        for gi in range(20):
            out.append(step(
                f"grid_gbm_{gi}", "gbm", 5, GROUP_GRIDS,
                ntrees=int(rng.choice([30, 50, 100])),
                max_depth=int(rng.integers(3, 10)),
                learn_rate=float(rng.choice([0.03, 0.05, 0.1, 0.2])),
                sample_rate=float(rng.uniform(0.6, 1.0)),
                col_sample_rate_per_tree=float(rng.uniform(0.5, 1.0))))
        return out

    def exploitation(self, ctx, best):
        if best is None:
            return []
        # GBMStepsProvider.exploitation 'lr_annealing': restart the family
        # best with a halved learning rate and a deeper tree budget
        p = {k: v for k, v in best._parms.items()
             if k in ("max_depth", "sample_rate",
                      "col_sample_rate_per_tree", "min_rows")
             and v is not None}
        lr = float(best._parms.get("learn_rate") or 0.1)
        nt = int(best._parms.get("ntrees") or 50)
        return [step("exploit_gbm_lr_annealing", "gbm", 10,
                     GROUP_EXPLOITATION, learn_rate=lr / 2.0,
                     ntrees=min(nt * 2, 400), **p)]


class XGBSteps(StepsProvider):
    algo = "xgboost"
    has_exploitation = True

    def defaults(self, ctx):
        return [
            step("def_xgb_1", "xgboost", 10, GROUP_DEFAULTS, ntrees=50,
                 max_depth=8, learn_rate=0.1, sample_rate=0.8),
            step("def_xgb_2", "xgboost", 10, GROUP_DEFAULTS, ntrees=100,
                 max_depth=5, learn_rate=0.05, reg_lambda=2.0),
        ]

    def exploitation(self, ctx, best):
        if best is None:
            return []
        lr = float(best._parms.get("learn_rate") or 0.1)
        nt = int(best._parms.get("ntrees") or 50)
        return [step("exploit_xgb_lr_search", "xgboost", 10,
                     GROUP_EXPLOITATION, learn_rate=lr / 2.0,
                     ntrees=min(nt * 2, 400),
                     max_depth=int(best._parms.get("max_depth") or 6))]


class DRFSteps(StepsProvider):
    algo = "drf"

    def defaults(self, ctx):
        return [step("def_drf", "drf", 10, GROUP_DEFAULTS, ntrees=50),
                step("def_drf_xrt", "drf", 10, GROUP_DEFAULTS, ntrees=100,
                     max_depth=25)]


class DLSteps(StepsProvider):
    algo = "deeplearning"

    def defaults(self, ctx):
        return [step("def_dl_1", "deeplearning", 10, GROUP_DEFAULTS,
                     hidden=[64, 64], epochs=20)]

    def grids(self, ctx, rng):
        out = []
        for gi in range(3):
            out.append(step(
                f"grid_dl_{gi}", "deeplearning", 5, GROUP_GRIDS,
                hidden=[int(rng.choice([32, 64, 128]))] *
                       int(rng.integers(1, 3)),
                epochs=int(rng.choice([10, 20, 40]))))
        return out


REGISTRY: Dict[str, StepsProvider] = {
    p.algo: p for p in (GLMSteps(), GBMSteps(), XGBSteps(), DRFSteps(),
                        DLSteps())}


def build_plan(ctx: Dict[str, Any], seed: int,
               include: Optional[List[str]],
               exclude: List[str]) -> List[Dict[str, Any]]:
    """Static phase plan (defaults + grids) in group order, providers
    filtered by include/exclude — ModelingStepsRegistry.getOrderedSteps."""
    rng = np.random.default_rng(seed)
    steps: List[Dict[str, Any]] = []
    for algo, prov in REGISTRY.items():
        if include and algo not in include:
            continue
        if algo in exclude:
            continue
        steps.extend(prov.defaults(ctx))
        steps.extend(prov.grids(ctx, rng))
    steps.sort(key=lambda s: s["group"])
    return steps


def exploitation_steps(ctx: Dict[str, Any],
                       best_by_algo: Dict[str, Any],
                       include: Optional[List[str]],
                       exclude: List[str]) -> List[Dict[str, Any]]:
    """Lazy exploitation plan against the live per-family leaders."""
    out: List[Dict[str, Any]] = []
    for algo, prov in REGISTRY.items():
        if include and algo not in include:
            continue
        if algo in exclude:
            continue
        out.extend(prov.exploitation(ctx, best_by_algo.get(algo)))
    return out
