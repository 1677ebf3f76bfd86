"""Extensions and user-defined Rapids functions (counterpart of
h2o3_tpu/extensions.py: `register_extension` :26, `run_extension_hooks`
:39, `register_udf` :58, `udfs` :85).

Reference: water/AbstractH2OExtension.java + water/ExtensionManager.java
(extensions get init hooks at cloud boot) and water/rapids/ast/AstApply
(user functions in Rapids).

An extension is a callable registered before or after init: its hook
runs at once if the runtime is booted, else at the next
`h2o3_tpu_torch.init()`, once. A UDF registers as the Rapids prim
``udf.<name>``, which runs on the host over the gathered column values
(numeric arrays, or object arrays of strings) and puts the result back
on the device of the first frame argument.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

_EXTENSIONS: Dict[str, Callable] = {}
_INITIALIZED: List[str] = []


def register_extension(name: str, init_hook: Callable) -> None:
    """Install an extension; its hook runs with the Cluster at boot (or
    now, if the runtime is already booted)."""
    from h2o3_tpu_torch.core import runtime

    _EXTENSIONS[name] = init_hook
    if runtime._CLUSTER is not None:
        init_hook(runtime._CLUSTER)
        if name not in _INITIALIZED:
            _INITIALIZED.append(name)


def run_extension_hooks(cluster) -> None:
    """Called at boot: each hook not yet run runs once. A failing hook is
    logged and counted as run; it does not stop the boot."""
    from h2o3_tpu_torch.utils import log

    for name, hook in list(_EXTENSIONS.items()):
        if name not in _INITIALIZED:
            _INITIALIZED.append(name)
            try:
                hook(cluster)
            except Exception as e:   # noqa: BLE001 — extension isolation
                log.warn(f"extension {name!r} init failed: "
                         f"{type(e).__name__}: {e}")


def extensions() -> List[str]:
    return sorted(_EXTENSIONS)


def register_udf(name: str, fn: Callable, ctype: str = "real") -> None:
    """Register `(udf.<name> frame ...)` as a Rapids prim: fn receives one
    host numpy array per input column (and each non-frame argument as
    is) and returns one row-aligned array. ctype: 'real', 'enum' or
    'string', the result column's type."""
    from h2o3_tpu_torch.core.frame import Column, Frame
    from h2o3_tpu_torch.rapids.eval import PRIMS, _is_fr

    def run(env, *args):
        cols, device = [], None
        for a in args:
            if _is_fr(a):
                for c in a.columns:
                    cols.append(c.to_numpy())
                    if device is None and c.data is not None:
                        device = c.data.device
            else:
                cols.append(a)
        result = np.asarray(fn(*cols))
        out = Frame()
        # 'string' results live on the host (ctype None from an object
        # array); there is no device storage for strings
        ct = None if ctype in ("real", "string") else ctype
        out.add(name, Column.from_numpy(result, ctype=ct, device=device))
        return out

    PRIMS[f"udf.{name}"] = run


def udfs() -> List[str]:
    from h2o3_tpu_torch.rapids.eval import PRIMS

    return sorted(p[4:] for p in PRIMS if p.startswith("udf."))
