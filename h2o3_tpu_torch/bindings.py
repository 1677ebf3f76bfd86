"""Bindings generator: estimator classes generated from the algo
registry (counterpart of h2o3_tpu/bindings.py: `generate_python` :31,
`write_python` :70, `load_generated` :77).

Reference: h2o-bindings/bin/gen_python.py + gen_R.py — walk the server's
/3/Metadata/schemas + ModelBuilders metadata and emit the h2o-py
`H2O<Algo>Estimator` classes with typed parameter properties.

Here the registry is the metadata source, so the code is a pure function
of the port's BUILDERS: one class per algo with its default parameters
in the docstring, usable in memory (`load_generated`) or written to disk
for packaging (`write_python`). A parameter's external spelling goes
through the builder's `translate_param` (XGBoost's aliases)."""

from __future__ import annotations

import io
from typing import Dict

_CAMEL = {"gbm": "GradientBoosting", "drf": "RandomForest",
          "glm": "GeneralizedLinear", "deeplearning": "DeepLearning",
          "kmeans": "KMeans", "pca": "PrincipalComponentAnalysis",
          "svd": "SingularValueDecomposition", "glrm": "GeneralizedLowRank",
          "naivebayes": "NaiveBayes", "isolationforest": "IsolationForest",
          "xgboost": "XGBoost", "word2vec": "Word2vec",
          "coxph": "CoxProportionalHazards", "psvm": "SupportVectorMachine",
          "rulefit": "RuleFit", "gam": "GeneralizedAdditive",
          "stackedensemble": "StackedEnsemble",
          "targetencoder": "TargetEncoder", "aggregator": "Aggregator",
          "extendedisolationforest": "ExtendedIsolationForest",
          "isotonicregression": "IsotonicRegression", "generic": "Generic"}


def _class_name(algo: str) -> str:
    return "H2O" + _CAMEL.get(algo.lower(), algo.capitalize()) + "Estimator"


def generate_python() -> str:
    """Emit the estimators module source (gen_python.py analog)."""
    from h2o3_tpu_torch.models.model_builder import BUILDERS

    out = io.StringIO()
    out.write('"""GENERATED by h2o3_tpu_torch.bindings.generate_python — one\n'
              'estimator class per registered algo (h2o-bindings analog).\n'
              'Regenerate after adding algos/params; do not hand-edit."""\n\n'
              "from h2o3_tpu_torch.models.model_builder import BUILDERS\n\n\n"
              "class _GenEstimator:\n"
              "    algo = None\n\n"
              "    def __init__(self, **params):\n"
              "        self._builder = BUILDERS[self.algo](**{\n"
              "            BUILDERS[self.algo].translate_param(k): v\n"
              "            for k, v in params.items()})\n\n"
              "    def train(self, *a, **kw):\n"
              "        self.model = self._builder.train(*a, **kw)\n"
              "        return self.model\n\n"
              "    def __getattr__(self, name):\n"
              "        if name == 'model':   # before train(): no recursion\n"
              "            raise AttributeError(\n"
              "                f'{type(self).__name__} not trained yet')\n"
              "        return getattr(self.model, name)\n\n\n")
    names = []
    for algo in sorted(BUILDERS):
        cls = BUILDERS[algo]
        cname = _class_name(algo)
        names.append(cname)
        out.write(f"class {cname}(_GenEstimator):\n")
        out.write(f'    """{algo} estimator (generated).\n\n'
                  '    Parameters\n')
        for k, v in sorted(cls.default_params().items()):
            out.write(f"      {k}: default {v!r}\n")
        out.write('    """\n\n')
        out.write(f"    algo = {algo!r}\n\n\n")
    out.write("__all__ = [\n" + "".join(f"    {n!r},\n" for n in names)
              + "]\n")
    return out.getvalue()


def write_python(path: str) -> str:
    src = generate_python()
    with open(path, "w") as f:
        f.write(src)
    return path


def load_generated() -> Dict[str, type]:
    """Exec the generated module in-memory and return its classes."""
    ns: Dict[str, object] = {}
    exec(compile(generate_python(), "<h2o3_tpu_torch.bindings>", "exec"), ns)
    return {k: v for k, v in ns.items() if isinstance(v, type)
            and k.startswith("H2O")}
