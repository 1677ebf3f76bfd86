"""The PyTorch port (h2o3_tpu_torch) stands alone: it imports with JAX,
optax, scipy and pandas blocked and the JAX package refused, its entry
points default to CUDA, and no source file of it (nor chip_smoke.py)
imports JAX, optax, scipy, pandas or h2o3_tpu. The one exception is
Frame.to_pandas, which imports pandas inside the method and raises
ImportError where pandas is absent."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "h2o3_tpu_torch"

_BLOCKED_IMPORT = r'''
import importlib, json, pkgutil, sys
sys.modules["jax"] = None

class RefuseReference:
    def find_spec(self, name, path=None, target=None):
        if name == "h2o3_tpu" or name.startswith("h2o3_tpu."):
            raise ImportError(f"refused {name}")
        return None

sys.meta_path.insert(0, RefuseReference())
sys.modules["optax"] = None
sys.modules["scipy"] = None
sys.modules["pandas"] = None
import h2o3_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    h2o3_tpu_torch.__path__, "h2o3_tpu_torch."))
for m in mods:
    importlib.import_module(m)
leaked = [k for k in sys.modules
          if k == "h2o3_tpu" or k.startswith("h2o3_tpu.")
          or (k in ("jax", "optax", "scipy", "pandas")
              and sys.modules[k] is not None)]
from h2o3_tpu_torch import kernels
from h2o3_tpu_torch import native
h2o3_tpu_torch.init(device="cpu")
try:
    h2o3_tpu_torch.H2OFrame({"a": [1.0]}).to_pandas()
    to_pandas = "ran"
except ImportError:
    to_pandas = "ImportError"
print(json.dumps({"modules": mods, "leaked": leaked, "to_pandas": to_pandas,
                  "built": len(kernels._LIBS) + (native._LIB is not None)}))
'''


def test_port_imports_with_jax_blocked_and_reference_refused():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    for name in ("models.tree.hist_gather", "models.tree.drf",
                 "core.random", "models.distribution", "ops.rollups",
                 "models.data_info", "models.tree.histogram",
                 "models.tree.host_grow", "models.tree.isofor",
                 "models.extended_isofor", "models.xgboost",
                 "models.glm", "models.gam", "models.rulefit",
                 "ops.quantile", "optim", "optim.lbfgs", "convert",
                 "native", "errors", "persist", "ingest.parse_setup",
                 "ingest.chunked", "ingest.parser", "ingest.formats",
                 "ingest.avro", "ingest.sql", "ingest.decrypt",
                 "models.deeplearning", "optim.sgd", "models.isotonic",
                 "ops.filters", "utils.twodim", "utils.unpickle",
                 "core.dkv", "frame_factory", "ops.elementwise", "ops.sort",
                 "ops.merge", "ops.groupby", "ops.window", "ops.impute",
                 "rapids", "rapids.parser", "rapids.eval",
                 "rapids.prims_ext", "models.kmeans", "models.pca",
                 "models.svd", "models.naive_bayes", "models.word2vec",
                 "models.ensemble", "models.target_encoder", "models.glrm",
                 "models.coxph", "models.psvm", "optim.bfgs",
                 "models.aggregator", "models.segments"):
        assert f"h2o3_tpu_torch.{name}" in rep["modules"], name
    assert len(rep["modules"]) >= 30, rep["modules"]
    assert rep["leaked"] == [], rep["leaked"]
    assert rep["to_pandas"] == "ImportError"
    assert rep["built"] == 0, "importing the port built a kernel or a " \
        "host library"


def test_builders_list_every_ported_algorithm():
    """BUILDERS maps the reference's algo names to the port's builders:
    every algorithm the JAX package registers but `generic` (it waits
    for the host MOJO reader, ROADMAP A12), each exported from the
    package under its class name."""
    import h2o3_tpu.models as ref
    import h2o3_tpu_torch as h2o

    assert sorted(h2o.BUILDERS) == sorted(set(ref.BUILDERS) - {"generic"})
    for algo, cls in h2o.BUILDERS.items():
        assert cls.algo_name == algo
        assert ref.BUILDERS[algo].__name__ == cls.__name__, algo
        assert getattr(h2o, cls.__name__) is cls, algo


def test_init_defaults_to_cuda_and_raises_without_it(monkeypatch):
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core import runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runtime, "_CLUSTER", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        h2o.init()
    with pytest.raises(RuntimeError):
        h2o.init(device="cuda")
    assert h2o.init(device="cpu").device == torch.device("cpu")


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|optax|scipy|pandas|h2o3_tpu)"
    r"(?:[.\s,]|$)",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_source_names_jax_or_the_reference(path):
    text = (ROOT / path).read_text()
    found = _FORBIDDEN.findall(text)
    if path == "h2o3_tpu_torch/core/frame.py":
        # Frame.to_pandas's import, inside the method
        found = [f for f in found if f != "        import pandas "]
    assert not found, \
        f"{path} imports jax, optax, scipy, pandas or h2o3_tpu"
