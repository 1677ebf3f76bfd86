"""Restricted unpickling of the port's saved models: the port's copy of
h2o3_tpu/utils/unpickle.py, narrowed to what a saved model holds.

A model file that arrives over shared storage or an upload is untrusted
input, and one plain ``pickle.load`` runs whatever callable the file
names. ``find_class`` here admits only:
- classes defined in the port (``h2o3_tpu_torch.*``, by the class's own
  ``__module__``), and the port's one rebuild function for tensors
  (`REBUILD`);
- numpy's array, dtype and scalar rebuilders;
- the builtin containers pickle names by reference.
Anything else, torch's own rebuild callables included, raises
:class:`pickle.UnpicklingError`: refuse, never fall back. A dotted name
is refused outright: from protocol 4 on, pickle resolves one by
following attributes, so ``h2o3_tpu_torch.native`` / ``subprocess.Popen``
would reach a class the port merely imports.
"""

from __future__ import annotations

import pickle
from typing import Any, BinaryIO

# module-level functions of the port a model file may call
REBUILD = {("h2o3_tpu_torch.models.model", "_tensor_from_numpy")}
_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "scalar"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar")}
_BUILTINS = {"set", "frozenset", "slice", "complex", "range", "bytearray"}


def _in_port(module: str) -> bool:
    return module == "h2o3_tpu_torch" or module.startswith("h2o3_tpu_torch.")


class RestrictedUnpickler(pickle.Unpickler):
    what = "payload"

    def find_class(self, module, name):
        if "." not in name:          # a dotted name follows attributes
            if (module == "builtins" and name in _BUILTINS) \
                    or (module, name) in _NUMPY or (module, name) in REBUILD:
                return super().find_class(module, name)
            if _in_port(module):
                obj = super().find_class(module, name)
                if isinstance(obj, type) and _in_port(obj.__module__):
                    return obj
        raise pickle.UnpicklingError(
            f"{self.what} references disallowed type {module}.{name}: "
            "refusing to unpickle (restricted loader)")


def restricted_load(fileobj: BinaryIO, what: str = "payload") -> Any:
    up = RestrictedUnpickler(fileobj)
    up.what = what
    return up.load()
