"""The PyTorch port (h2o3_tpu_torch) stands alone: it imports with JAX,
optax and scipy blocked and the JAX package refused, its entry points
default to CUDA, and no source file of it (nor chip_smoke.py) imports
JAX, optax, scipy or h2o3_tpu."""

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
import h2o3_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    h2o3_tpu_torch.__path__, "h2o3_tpu_torch."))
for m in mods:
    importlib.import_module(m)
leaked = [k for k in sys.modules
          if k == "h2o3_tpu" or k.startswith("h2o3_tpu.")
          or (k in ("jax", "optax", "scipy") and sys.modules[k] is not None)]
from h2o3_tpu_torch import kernels
print(json.dumps({"modules": mods, "leaked": leaked,
                  "built": len(kernels._LIBS)}))
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
                 "ops.quantile", "optim", "optim.lbfgs", "convert"):
        assert f"h2o3_tpu_torch.{name}" in rep["modules"], name
    assert len(rep["modules"]) >= 30, rep["modules"]
    assert rep["leaked"] == [], rep["leaked"]
    assert rep["built"] == 0, "importing the port built a kernel"


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
    r"^\s*(?:import|from)\s+(?:jax|optax|scipy|h2o3_tpu)(?:[.\s,]|$)",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_source_names_jax_or_the_reference(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), \
        f"{path} imports jax, optax, scipy or h2o3_tpu"
