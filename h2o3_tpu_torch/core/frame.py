"""Columnar store: Frame / Column on torch tensors (counterpart of
h2o3_tpu/core/frame.py).

Storage rules are the reference's: one dense tensor per column, numeric
columns float32 with NaN as NA, categorical columns integer codes of the
narrowest dtype that fits the domain (`code_dtype`) with -1 as NA, and
domains kept on the host. The reference pads rows to a multiple of its
mesh; on one device nothing is padded, so a column holds exactly `nrows`
values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

T_NUM = "real"
T_INT = "int"
T_CAT = "enum"
T_STR = "string"

NA_CAT = -1


def code_dtype(n_levels: int):
    """Narrowest signed code dtype that fits the domain plus the -1 NA
    sentinel (h2o3_tpu/core/frame.py:48)."""
    if n_levels <= 126:
        return np.int8
    if n_levels <= 32766:
        return np.int16
    return np.int32


def _device(device):
    if device is not None:
        return torch.device(device)
    from h2o3_tpu_torch.core.runtime import cluster

    return cluster().device


class Column:
    """One column: `data` is an (nrows,) tensor (float32 for real/int, a
    narrow integer code dtype for enum) or None for host-only strings,
    whose values live in `host_data`."""

    __slots__ = ("data", "ctype", "domain", "host_data", "nrows", "_rollups")

    def __init__(self, data, ctype: str, nrows: int,
                 domain: Optional[List[str]] = None,
                 host_data: Optional[np.ndarray] = None):
        self.data = data
        self.ctype = ctype
        self.domain = domain
        self.host_data = host_data
        self.nrows = int(nrows)
        self._rollups = None

    @staticmethod
    def from_numpy(arr, ctype: Optional[str] = None,
                   domain: Optional[List[str]] = None,
                   device=None) -> "Column":
        """Host array -> column on `device` (default: the runtime's)."""
        arr = np.asarray(arr)
        n = len(arr)
        if ctype is None:
            if arr.dtype.kind in "OUS":
                return Column(None, T_STR, n, host_data=arr.astype(object))
            if arr.dtype.kind not in "fiub":
                raise TypeError(f"unsupported dtype {arr.dtype}")
            ctype = T_INT if arr.dtype.kind in "iub" else T_NUM
        if ctype == T_CAT:
            if arr.dtype.kind in "OUS":
                domain, codes = _intern_domain(arr)
            elif arr.dtype.kind == "f":
                a = arr.astype(np.float64)
                codes = np.where(np.isnan(a), NA_CAT, a).astype(np.int32)
            else:
                codes = arr.astype(np.int32)
            card = (len(domain) if domain is not None
                    else int(max(codes.max(initial=0) + 1, 1)))
            buf = codes.astype(code_dtype(card))
        elif ctype in (T_NUM, T_INT):
            buf = arr.astype(np.float64).astype(np.float32)
        else:
            raise TypeError(f"cannot store ctype {ctype} on a device")
        data = torch.from_numpy(np.ascontiguousarray(buf)).to(_device(device))
        return Column(data, ctype, n, domain=domain)

    @property
    def is_numeric(self) -> bool:
        return self.ctype in (T_NUM, T_INT)

    @property
    def is_categorical(self) -> bool:
        return self.ctype == T_CAT

    @property
    def is_string(self) -> bool:
        return self.ctype == T_STR

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain else 0

    @property
    def rollups(self):
        """min/max/mean/sigma/na/nz of the column, computed on first use
        (ops/rollups.py; columns are not written in place, so the cache
        stays valid)."""
        if self._rollups is None:
            from h2o3_tpu_torch.ops.rollups import compute_rollups

            self._rollups = compute_rollups(self)
        return self._rollups

    def to_numpy(self) -> np.ndarray:
        if self.data is None:
            return self.host_data[: self.nrows]
        return self.data.cpu().numpy()

    def values(self) -> np.ndarray:
        """User-facing values (enum codes -> labels, NA -> None)."""
        arr = self.to_numpy()
        if self.ctype == T_CAT and self.domain is not None:
            dom = np.asarray(self.domain, dtype=object)
            out = np.empty(len(arr), dtype=object)
            valid = arr >= 0
            out[valid] = dom[arr[valid]]
            out[~valid] = None
            return out
        return arr


def _intern_domain(a: np.ndarray) -> Tuple[List[str], np.ndarray]:
    """String labels -> (sorted domain, int32 codes); None/NaN/"" -> NA."""
    mask_na = np.array([x is None or (isinstance(x, float) and math.isnan(x))
                        or x == "" for x in a], bool)
    vals = np.asarray([("" if m else str(x)) for x, m in zip(a, mask_na)])
    dom = sorted(set(vals[~mask_na].tolist()))
    lookup = {v: i for i, v in enumerate(dom)}
    codes = np.array([NA_CAT if m else lookup[v]
                      for v, m in zip(vals, mask_na)], np.int32)
    return dom, codes


class Frame:
    """Named, ordered collection of equal-length Columns."""

    def __init__(self, columns: Optional[Dict[str, Column]] = None):
        self._names: List[str] = []
        self._cols: Dict[str, Column] = {}
        for name, col in (columns or {}).items():
            self.add(name, col)

    @property
    def names(self) -> List[str]:
        return list(self._names)

    @property
    def ncols(self) -> int:
        return len(self._names)

    @property
    def nrows(self) -> int:
        return self._cols[self._names[0]].nrows if self._names else 0

    def col(self, name_or_idx: Union[str, int]) -> Column:
        if isinstance(name_or_idx, int):
            return self._cols[self._names[name_or_idx]]
        return self._cols[name_or_idx]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def add(self, name: str, col: Column) -> "Frame":
        if self._names and col.nrows != self.nrows:
            raise ValueError(f"column {name!r} has {col.nrows} rows, frame "
                             f"has {self.nrows}")
        if name in self._cols:
            raise ValueError(f"duplicate column {name!r}")
        self._names.append(name)
        self._cols[name] = col
        return self

    def drop(self, name: str) -> "Frame":
        self._names.remove(name)
        self._cols.pop(name)
        return self

    def subframe(self, names: Sequence[Union[str, int]]) -> "Frame":
        fr = Frame()
        for n in names:
            nm = self._names[n] if isinstance(n, int) else n
            fr.add(nm, self._cols[nm])
        return fr

    def to_numpy(self) -> np.ndarray:
        return np.column_stack([self._cols[n].to_numpy()
                                for n in self._names])

    def __repr__(self) -> str:
        return f"<Frame {self.nrows}x{self.ncols} {self._names[:8]}>"
