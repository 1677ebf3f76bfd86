"""Assembly: fit and apply munging pipelines (counterpart of
h2o3_tpu/assembly.py: `H2OColSelect` :23, `H2OColOp` :39, `H2OScaler`
:90, `H2OBinaryOp` :125, `H2OAssembly` :151, `RestStep` :290).

Reference: h2o-core/src/main/java/water/rapids/Assembly.java + h2o-py's
h2o/assembly.py (H2OAssembly) and h2o/transforms/preprocessing.py
(H2OColSelect / H2OColOp / H2OScaler / H2OBinaryOp): an ordered list of
named frame transforms that fits once, applies to any frame, and
persists as a scoring artifact.

Each step runs torch ops on the frame's columns, on their device; a
step decoded from the REST wire format (`from_steps`) runs its Rapids
expression through the port's evaluator. The fitted pipeline saves with
a versioned header and loads through the restricted unpickler.
`export_pipeline` fuses an assembly's Rapids steps with a model's
scoring into one pipeline artifact (artifact/pipeline.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM


class H2OColSelect:
    """Keep only the named columns (h2o-py H2OColSelect)."""

    def __init__(self, cols: Sequence[str]):
        self.cols = list(cols)

    def fit_transform(self, fr: Frame) -> Frame:
        return self.transform(fr)

    def transform(self, fr: Frame) -> Frame:
        missing = [c for c in self.cols if c not in fr]
        if missing:
            raise ValueError(f"H2OColSelect: missing columns {missing}")
        return fr.subframe(self.cols)


class H2OColOp:
    """Apply a unary op to one column (h2o-py H2OColOp): `op` is the name
    of a torch function (e.g. "cos") or such a function; the reference
    takes the jax.numpy function of the same name."""

    def __init__(self, op, col: str, new_col_name: Optional[str] = None,
                 inplace: bool = True):
        # a callable is kept by its name: the pipeline must pickle, and
        # derived column names must be stable across processes
        if callable(op):
            op = getattr(op, "__name__", None) or str(op)
        self.op = str(op)
        if not callable(getattr(torch, self.op, None)):
            raise ValueError(f"H2OColOp: unknown op {self.op!r} "
                             "(must name a torch function)")
        self.col = col
        self.new_col_name = new_col_name
        self.inplace = bool(inplace)

    def _fn(self) -> Callable:
        return getattr(torch, self.op)

    def fit_transform(self, fr: Frame) -> Frame:
        return self.transform(fr)

    def transform(self, fr: Frame) -> Frame:
        c = fr.col(self.col)
        out_data = self._fn()(c.data)
        name = self.new_col_name or (self.col if self.inplace
                                     else f"{self.op}_{self.col}")
        out = Frame()
        for nm in fr.names:
            if nm == self.col and self.inplace:
                out.add(name, Column(out_data, T_NUM, c.nrows))
            else:
                out.add(nm, fr.col(nm))
        if not self.inplace:
            out.add(name, Column(out_data, T_NUM, c.nrows))
        return out


class H2OScaler:
    """Standardize numeric columns with the training means and standard
    deviations (h2o-py H2OScaler): fitted once, reused at apply time."""

    def __init__(self, center: bool = True, scale: bool = True):
        self.center = bool(center)
        self.scale = bool(scale)
        self.means: Dict[str, float] = {}
        self.sds: Dict[str, float] = {}

    def fit_transform(self, fr: Frame) -> Frame:
        for nm in fr.names:
            c = fr.col(nm)
            if c.is_numeric:
                vals = c.to_numpy()
                self.means[nm] = float(np.nanmean(vals))
                sd = float(np.nanstd(vals))
                self.sds[nm] = sd if sd > 0 else 1.0
        return self.transform(fr)

    def transform(self, fr: Frame) -> Frame:
        out = Frame()
        for nm in fr.names:
            c = fr.col(nm)
            if nm in self.means:
                d = c.data
                if self.center:
                    d = d - self.means[nm]
                if self.scale:
                    d = d / self.sds[nm]
                out.add(nm, Column(d, T_NUM, c.nrows))
            else:
                out.add(nm, c)
        return out


class H2OBinaryOp:
    """colA <op> colB -> a new column (h2o-py H2OBinaryOp)."""

    _OPS = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide"}

    def __init__(self, op: str, left: str, right: str,
                 new_col_name: Optional[str] = None):
        if op not in self._OPS:
            raise ValueError(
                f"H2OBinaryOp: op must be one of {list(self._OPS)}")
        self.op = op
        self.left = left
        self.right = right
        self.new_col_name = new_col_name or f"{left}{op}{right}"

    def fit_transform(self, fr: Frame) -> Frame:
        return self.transform(fr)

    def transform(self, fr: Frame) -> Frame:
        a, b = fr.col(self.left).data, fr.col(self.right).data
        v = getattr(torch, self._OPS[self.op])(a, b)
        out = Frame()
        for nm in fr.names:
            out.add(nm, fr.col(nm))
        out.add(self.new_col_name, Column(v, T_NUM, fr.nrows))
        return out


class H2OAssembly:
    """Ordered named steps: fit() runs fit_transform through the chain,
    transform() replays it with the fitted statistics
    (water/rapids/Assembly.java)."""

    _SAVE_MAGIC = b"H2OTRCHA"
    _SAVE_VERSION = 1

    def __init__(self, steps: Sequence[Tuple[str, Any]]):
        self.steps = list(steps)
        self.fitted = False

    def fit(self, frame: Frame) -> Frame:
        out = frame
        for _name, step in self.steps:
            out = step.fit_transform(out)
        self.fitted = True
        return out

    def transform(self, frame: Frame) -> Frame:
        if not self.fitted:
            raise RuntimeError("assembly not fitted — call fit() first")
        out = frame
        for _name, step in self.steps:
            out = step.transform(out)
        return out

    @property
    def names(self) -> List[str]:
        return [n for n, _s in self.steps]

    # -- persistence (the munging artifact) -------------------------------
    def save(self, path: str) -> str:
        import pickle
        import struct

        with open(path, "wb") as f:
            f.write(self._SAVE_MAGIC)
            f.write(struct.pack("<H", self._SAVE_VERSION))
            pickle.dump(self, f)
        return path

    @staticmethod
    def load(path: str) -> "H2OAssembly":
        """Load a saved assembly through the restricted unpickler: an
        assembly file is untrusted input, like a model file."""
        import struct

        from h2o3_tpu_torch.utils.unpickle import restricted_load

        with open(path, "rb") as f:
            if f.read(8) != H2OAssembly._SAVE_MAGIC:
                raise ValueError(f"{path!r} is not an assembly artifact")
            (ver,) = struct.unpack("<H", f.read(2))
            if ver > H2OAssembly._SAVE_VERSION:
                raise ValueError(f"assembly artifact version {ver} too new")
            return restricted_load(f, what="assembly artifact")

    # -- REST wire format (h2o-py transform_base.to_rest) ----------------
    @staticmethod
    def from_steps(step_strings: Sequence[str]) -> "H2OAssembly":
        """Decode the POST /99/Assembly `steps` payload: each entry is
        `name__ClassName__(rapids ast over 'dummy')__inplace__newcols`
        (h2o-py transforms/transform_base.py to_rest; server counterpart
        water/rapids/transforms/H2OColOp.java:28)."""
        steps: List[Tuple[str, Any]] = []
        for raw in step_strings:
            s = str(raw).strip().strip('"').strip("'")
            parts = s.split("__")
            if len(parts) < 5:
                raise ValueError(f"bad assembly step {s!r}")
            name, klass, ast, inplace, newcols = (
                parts[0], parts[1], "__".join(parts[2:-2]),
                parts[-2], parts[-1])
            new_names = [c for c in newcols.split("|") if c]
            steps.append((name, RestStep(
                klass, ast, inplace.strip().lower() == "true", new_names)))
        return H2OAssembly(steps)

    def describe(self) -> List[str]:
        return [f"{n}: {getattr(s, 'describe', lambda: type(s).__name__)()}"
                for n, s in self.steps]

    def export_pipeline(self, model, frame: Frame, out_dir: str,
                        buckets: Optional[Sequence[int]] = None):
        """Fuse this assembly's munge with `model`'s scoring into one
        standalone pipeline artifact: the steps replay lazily through a
        private Rapids session, so every engineered column stays a
        pending expression node, and the exporter splices those nodes
        into the model's scoring program. The runner then scores raw
        rows in `frame`'s schema. Only Rapids-backed steps (the REST wire
        format) stay lazy; steps that touch column data (H2OScaler and
        the like) make their outputs, and the export refuses with the
        reason. Returns the written manifest."""
        import uuid

        from h2o3_tpu_torch.artifact.pipeline import (
            export_pipeline as _export)
        from h2o3_tpu_torch.rapids import Session
        from h2o3_tpu_torch.rapids import planner as lazy_planner

        sess = Session(f"assembly_pipe_{uuid.uuid4().hex[:8]}")
        try:
            with lazy_planner.force(True):
                out = frame
                for _name, step in self.steps:
                    if isinstance(step, RestStep):
                        out = step.transform(out, session=sess)
                    elif self.fitted:
                        out = step.transform(out)
                    else:
                        out = step.fit_transform(out)
                return _export(model, out, out_dir,
                               buckets=list(buckets) if buckets else None)
        finally:
            sess.end()

    def to_source(self, name: str = "MungePipeline") -> str:
        """The pipeline as commented Rapids that any client can replay
        (the reference emits a Java munging POJO via GET
        /99/Assembly.java)."""
        lines = [f"// {name} — munging pipeline export (h2o3_tpu_torch)",
                 "// Replay: POST each Rapids expression below with the",
                 "// target frame id substituted for 'dummy'."]
        for n, s in self.steps:
            lines.append(f"// step {n}")
            lines.append(getattr(s, "ast", f"(noop {type(s).__name__})"))
        return "\n".join(lines) + "\n"


class RestStep:
    """One wire-decoded munging step, with the reference's column-splice
    semantics (water/rapids/transforms/H2OColOp.java transformImpl:
    substitute the frame, run the ast, then replace or append
    columns)."""

    def __init__(self, klass: str, ast: str, inplace: bool,
                 new_names: List[str]):
        self.klass = klass
        self.ast = ast
        self.inplace = inplace
        self.new_names = new_names

    def describe(self) -> str:
        return f"{self.klass}(inplace={self.inplace}) {self.ast}"

    def _old_col(self) -> Optional[str]:
        import re

        m = re.search(r"\(cols(?:_py)?\s+dummy\s+'([^']+)'\)", self.ast) or \
            re.search(r'\(cols(?:_py)?\s+dummy\s+"([^"]+)"\)', self.ast)
        return m.group(1) if m else None

    def _exec(self, fr: Frame, session=None):
        import re

        from h2o3_tpu_torch.core.dkv import Key
        from h2o3_tpu_torch.rapids import exec_rapids

        expr = re.sub(r"\bdummy\b", str(fr.key), self.ast)
        if session is not None:
            # bound to a session temp: assignments are what the lazy
            # planner defers, so the step stays a pending DAG node (the
            # pipeline-artifact export path)
            expr = f"(tmp= {Key.make('assembly_t')} {expr})"
        return exec_rapids(expr, session)

    def fit_transform(self, fr: Frame) -> Frame:
        return self.transform(fr)

    def transform(self, fr: Frame, session=None) -> Frame:
        fr.install()
        res = self._exec(fr, session)
        if self.klass == "H2OColSelect":
            return res if isinstance(res, Frame) else fr
        old = self._old_col()
        out = Frame()
        res_cols = (list(res.names) if isinstance(res, Frame) else [None])
        if isinstance(res, Frame) and len(res_cols) == 1:
            new_col = res.col(res_cols[0])
            if self.inplace and old is not None:
                for nm in fr.names:
                    out.add(nm, new_col if nm == old else fr.col(nm))
            else:
                for nm in fr.names:
                    out.add(nm, fr.col(nm))
                nm = self.new_names[0] if self.new_names else \
                    f"{old or 'col'}0"
                out.add(nm, new_col)
            return out
        if isinstance(res, Frame):       # multi-column result
            for nm in fr.names:
                if self.inplace and nm == old:
                    continue
                out.add(nm, fr.col(nm))
            for i, rn in enumerate(res_cols):
                nm = (self.new_names[i] if i < len(self.new_names)
                      else f"{old or 'col'}{i}")
                out.add(nm, res.col(rn))
            return out
        return fr
