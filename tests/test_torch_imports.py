"""The PyTorch port (h2o3_tpu_torch) stands alone: it imports with JAX,
optax, scipy, pandas and ml_dtypes blocked and the JAX package and its
standalone MOJO runtime (h2o3_genmodel) refused (its bf16 storage, its
invariant analyzer and its control plane run so too), its entry points
default to CUDA (a `distributed.initialize()` without an address too),
and no source file of it (nor chip_smoke.py) imports JAX, optax, scipy,
pandas, ml_dtypes, h2o3_tpu or h2o3_genmodel. The one exception is
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
        if name.split(".")[0] in ("h2o3_tpu", "h2o3_genmodel"):
            raise ImportError(f"refused {name}")
        return None

sys.meta_path.insert(0, RefuseReference())
sys.modules["optax"] = None
sys.modules["scipy"] = None
sys.modules["pandas"] = None
sys.modules["ml_dtypes"] = None
import h2o3_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    h2o3_tpu_torch.__path__, "h2o3_tpu_torch."))
for m in mods:
    importlib.import_module(m)
leaked = [k for k in sys.modules
          if k.split(".")[0] in ("h2o3_tpu", "h2o3_genmodel")
          or (k in ("jax", "optax", "scipy", "pandas", "ml_dtypes")
              and sys.modules[k] is not None)]
from h2o3_tpu_torch import kernels
from h2o3_tpu_torch import native
h2o3_tpu_torch.init(device="cpu", numeric_dtype="bfloat16")
import numpy as np
from h2o3_tpu_torch.models.tree.binning import BinSpec
fr = h2o3_tpu_torch.Frame()
fr.add("x", h2o3_tpu_torch.Column.from_numpy(np.linspace(-1, 1, 64)))
bf16 = str(fr.col("x").data.dtype)
BinSpec.build(fr, ["x"]).bin_columns(fr)
fr.col("x").mean()
from h2o3_tpu_torch.analysis import core as acore
acore.make_context()
from h2o3_tpu_torch.parallel import distributed as D, oplog, supervisor
with D.memory_kv():
    D.process_count = lambda: 2
    oplog.publish("noop", {})
    supervisor.evaluate()
D.process_count = lambda: 1
h2o3_tpu_torch.init(device="cpu", numeric_dtype="float32")
leaked += [k for k in sys.modules
           if k.split(".")[0] in ("h2o3_tpu", "h2o3_genmodel")
           or (k in ("jax", "optax", "scipy", "pandas", "ml_dtypes")
               and sys.modules[k] is not None)]
try:
    h2o3_tpu_torch.H2OFrame({"a": [1.0]}).to_pandas()
    to_pandas = "ran"
except ImportError:
    to_pandas = "ImportError"
print(json.dumps({"modules": mods, "leaked": leaked, "to_pandas": to_pandas,
                  "built": len(kernels._LIBS) + (native._LIB is not None),
                  "bf16": bf16}))
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
                 "models.aggregator", "models.segments", "core.job",
                 "grid", "automl", "automl.automl", "automl.search",
                 "automl.steps", "estimators", "extensions", "assembly",
                 "bindings", "utils.log", "models.gbm", "models.drf",
                 "models.isofor", "models.mojo", "models.mojo_java",
                 "models.pojo", "models.generic", "explain",
                 "scoring", "admission", "memory", "memory.budget",
                 "memory.stream", "core.failure", "core.cleaner",
                 "persist.spill", "utils.retry", "artifact",
                 "artifact.manifest", "artifact.packer", "artifact.aot",
                 "artifact.compile_cache", "artifact.glm",
                 "artifact.export", "artifact.loader", "artifact.runner",
                 "api", "api.server", "api.schemas", "api.routes_ext",
                 "obs", "obs.metrics", "obs.tracing", "obs.flight",
                 "obs.phases", "obs.compiles", "parallel",
                 "parallel.distributed", "parallel.oplog",
                 "parallel.supervisor", "parallel.ckpt",
                 "parallel.watchdog", "client", "utils.timeline",
                 "persist.s3", "analysis", "analysis.__main__",
                 "analysis.core", "analysis.callgraph",
                 "analysis.registry", "analysis.passes_locks",
                 "analysis.passes_mirrored", "analysis.passes_misc",
                 "analysis.passes_registries"):
        assert f"h2o3_tpu_torch.{name}" in rep["modules"], name
    assert len(rep["modules"]) >= 30, rep["modules"]
    assert rep["leaked"] == [], rep["leaked"]
    assert rep["to_pandas"] == "ImportError"
    assert rep["built"] == 0, "importing the port built a kernel or a " \
        "host library"
    assert rep["bf16"] == "torch.bfloat16"


def test_builders_list_every_ported_algorithm():
    """BUILDERS maps the reference's algo names to the port's builders:
    every algorithm the JAX package registers, `generic` included, each
    exported from the package under its class name."""
    import h2o3_tpu.models as ref
    import h2o3_tpu_torch as h2o

    assert sorted(h2o.BUILDERS) == sorted(ref.BUILDERS)
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


def test_initialize_without_an_address_leaves_one_process_on_the_card(
        monkeypatch):
    """`distributed.initialize()` with no coordinator address is a no-op:
    one process, index 0, its own coordinator, no store and no oplog;
    the runtime still defaults to the card."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core import runtime
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog

    monkeypatch.delenv("H2O_TPU_COORDINATOR", raising=False)
    monkeypatch.setenv("H2O_TPU_NUM_PROCESSES", "4")    # no address: unread
    monkeypatch.setenv("H2O_TPU_PROCESS_ID", "2")
    D.initialize()
    assert (D.process_count(), D.process_index()) == (1, 0)
    assert D.is_coordinator() and D._STORE is None
    assert not oplog.active() and oplog.broadcast("noop", {}) is None
    assert D.kv_put("k", "v") is False and D.kv_try_get("k") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runtime, "_CLUSTER", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        h2o.init()


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|optax|scipy|pandas|ml_dtypes|h2o3_tpu|"
    r"h2o3_genmodel)"
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
        f"{path} imports jax, optax, scipy, pandas, ml_dtypes, h2o3_tpu " \
        "or h2o3_genmodel"


def test_runner_imports_only_torch_numpy_and_the_standard_library():
    """The standalone runner ships to serving hosts without the package:
    every import it names (at any depth) is torch, numpy or a standard-
    library module."""
    import ast

    tree = ast.parse((PORT / "artifact" / "runner.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import in runner.py"
            roots.add(node.module.split(".")[0])
    allowed = {"torch", "numpy", "__future__"} | set(sys.stdlib_module_names)
    assert roots and roots <= allowed, roots - allowed
