"""Elementwise column ops (counterpart of h2o3_tpu/ops/elementwise.py).

Each op is one or a few PyTorch elementwise kernels on the column's
device, with H2O's NA semantics: NaN propagates through arithmetic,
comparisons with an NA side are NA, `&`/`|` follow three-valued logic
(0 & NA = 0, 1 | NA = 1). Scalars are cast to float32 before the op, as
the reference casts them.

Where a torch function answers differently from the reference's jnp one,
the reference's definition is written out here:
- `sign` keeps NaN (torch.sign(nan) is 0);
- `lgamma` and `digamma` are the reference's own float32 Lanczos
  approximations (XLA's chlo.lgamma and chlo.digamma, g = 7, with the
  reflection formula below 0.5), not torch's, which differ from them by
  up to 1.5e-4 of |gamma| for negative arguments; digamma is NaN at 0,
  -0 and the negative integers (torch.digamma gives ±inf at ±0);
- `%` and `intDiv` are jnp.remainder and jnp.floor_divide's float
  formulas over fmod (CPython's float_divmod), so NaN for a 0 divisor and
  the same signed zeros;
- `gamma` is exp(lgamma(x)) and `trigamma` the reference's recurrence
  plus asymptotic series.
`+ - * /`, the comparisons, `floor`/`ceiling`/`round`/`trunc` and `abs`
are single correctly rounded float32 operations in both packages; `sqrt`
(on the CPU neither library rounds it correctly every time) and the
transcendental functions agree to about an ulp (ROADMAP C2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, T_CAT, T_NUM

_PI = np.float32(math.pi)


def cat_to_f32(d: torch.Tensor) -> torch.Tensor:
    """Enum codes -> float32 with the NA code -1 as NaN."""
    return torch.where(d >= 0, d.float(), torch.nan)


def _as_f32(col: Column) -> torch.Tensor:
    """A column's float32 view with NaN NAs."""
    if col.ctype == T_CAT:
        return cat_to_f32(col.data)
    return col.data


def _scalar_like(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=like.device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: NaN stays NaN, -0 stays -0."""
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """lax.round's default: half away from zero."""
    t = torch.trunc(x)
    return torch.where(torch.abs(x - t) >= 0.5, t + torch.sign(x), t)


def _remainder(a, b):
    """jnp.remainder (Python's sign convention) for floats."""
    m = torch.fmod(a, b)
    plus = ((m < 0) != (b < 0)) & (m != 0)
    return torch.where(plus, m + b, m)


def _floor_divide(a, b):
    """jnp.floor_divide for floats (CPython's float_divmod)."""
    m = torch.fmod(a, b)
    div = (a - m) / b
    ind = (m != 0) & (_sign(b) != _sign(m))
    return _round_away(torch.where(ind, div - 1, div))


_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)


def _lanczos_z(x):
    """(reflect, z): z = -x below 0.5 (the reflection), else x - 1."""
    reflect = x < 0.5
    return reflect, torch.where(reflect, -x, x - 1.0)


def _log_t(z):
    """(t, log t) with t = g + 1/2 + z; log t through log1p."""
    gh = _scalar_like(_LANCZOS_G + 0.5, z)
    return gh + z, (_scalar_like(math.log(_LANCZOS_G + 0.5), z)
                    + torch.log1p(z / gh))


def _lgamma(x):
    """log|gamma(x)|, the reference's float32 Lanczos approximation; the
    one multiply-add the reference's compiler fuses is rounded once."""
    reflect, z = _lanczos_z(x)
    a = _scalar_like(_LANCZOS_BASE, x)
    for i, c in enumerate(_LANCZOS):
        a = a + _scalar_like(c, x) / (z + _scalar_like(i + 1, x))
    t, log_t = _log_t(z)
    r = z + 0.5 - t / log_t
    c0 = np.float32((math.log(2) + math.log(math.pi)) / 2)
    y = (float(c0) + r.double() * log_t.double()).float() + torch.log(a)
    # reflection: log(pi) - lgamma(1 - x) - log|sin(pi x)|, with sin
    # taken of the fractional part folded into [0, 1/2]
    ax = torch.abs(x)
    fr = ax - torch.floor(ax)
    fr = torch.where(fr > 0.5, 1.0 - fr, fr)
    den = torch.log(torch.sin(_pi_times(fr)))
    refl = torch.where(torch.isfinite(den),
                       _scalar_like(math.log(math.pi), x) - den - y, -den)
    out = torch.where(reflect, refl, y)
    return torch.where(torch.isinf(x), torch.inf, out)


def _digamma(x):
    """psi(x), the reference's float32 Lanczos approximation; NaN at 0,
    -0 and the negative integers."""
    reflect, z = _lanczos_z(x)
    num = torch.zeros_like(x)
    den = torch.full_like(x, np.float32(_LANCZOS_BASE))
    for i, c in enumerate(_LANCZOS):
        zt = z + _scalar_like(i + 1, x)
        num = num - _scalar_like(c, x) / (zt * zt)
        den = den + _scalar_like(c, x) / zt
    t, log_t = _log_t(z)
    y = log_t + num / den - _scalar_like(_LANCZOS_G, x) / t
    # reflection: psi(1 - x) - pi cot(pi x), x moved into [-1/2, 1/2]
    px = _pi_times(x + torch.abs(torch.floor(x + 0.5)))
    refl = y - _pi_times(torch.cos(px)) / torch.sin(px)
    out = torch.where(reflect, refl, y)
    pole = (x <= 0) & (x == torch.floor(x))
    return torch.where(pole, torch.nan, out)


def _trigamma(x):
    """psi'(x): the recurrence psi'(x) = 1/x^2 + psi'(x+1) shifted to
    z = x + 8, then 1/z + 1/2z^2 + 1/6z^3 - 1/30z^5 + 1/42z^7; NaN for
    x <= 0 (the reference's definition)."""
    acc = torch.zeros_like(x)
    z = x
    for _ in range(8):
        acc = acc + 1.0 / (z * z)
        z = z + 1.0
    zi = 1.0 / z
    zi2 = zi * zi
    asym = zi + 0.5 * zi2 + zi * zi2 * (1.0 / 6.0 - zi2 * (1.0 / 30.0
                                                           - zi2 / 42.0))
    return torch.where(x > 0, acc + asym, torch.nan)


def _pi_times(x):
    return _scalar_like(_PI, x) * x


_BINOPS = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "^": torch.pow, "%": _remainder, "intDiv": _floor_divide,
}
_CMPOPS = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
           ">": torch.gt, ">=": torch.ge}
_UNOPS = {
    "abs": torch.abs, "exp": torch.exp, "log": torch.log, "log2": torch.log2,
    "log10": torch.log10, "log1p": torch.log1p, "expm1": torch.expm1,
    "sqrt": torch.sqrt, "floor": torch.floor, "ceiling": torch.ceil,
    "round": torch.round, "trunc": torch.trunc, "sign": _sign,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "cospi": lambda x: torch.cos(_pi_times(x)),
    "sinpi": lambda x: torch.sin(_pi_times(x)),
    "tanpi": lambda x: torch.tan(_pi_times(x)),
    "gamma": lambda x: torch.exp(_lgamma(x)),
    "lgamma": _lgamma,
    "digamma": _digamma,
    "trigamma": _trigamma,
    "not": lambda x: torch.where(torch.isnan(x), torch.nan,
                                 (x == 0).float()),
}


def binop_expr(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Binary op with H2O NA semantics on float32 tensors: arithmetic
    lets NaN propagate; comparisons make NA rows NA."""
    if op in _CMPOPS:
        na = torch.isnan(a) | torch.isnan(b)
        return torch.where(na, torch.nan, _CMPOPS[op](a, b).float())
    return _BINOPS[op](a, b).float()


def _operands(left, right):
    lcol = isinstance(left, Column)
    ref = left if lcol else right
    dev_t = _as_f32(ref)
    a = _as_f32(left) if lcol else _scalar_like(left, dev_t)
    b = (_as_f32(right) if isinstance(right, Column)
         else _scalar_like(right, dev_t))
    return a, b, ref


def binop(op: str, left, right) -> Column:
    """left/right: Column or scalar (at least one Column). A new numeric
    column."""
    a, b, ref = _operands(left, right)
    return Column.from_device(binop_expr(op, a, b), T_NUM, ref.nrows)


def unop(op: str, col: Column) -> Column:
    out = _UNOPS[op](_as_f32(col)).float()
    return Column.from_device(out, T_NUM, col.nrows)


def ifelse_expr(c, a, b):
    """(ifelse cond yes no): an NA cond gives NA."""
    return torch.where(torch.isnan(c), torch.nan, torch.where(c != 0, a, b))


def logical_expr(op: str, a, b):
    """`&`/`|` with H2O's three-valued logic."""
    na = torch.isnan(a) | torch.isnan(b)
    if op == "&":
        return torch.where((a == 0) | (b == 0), 0.0,
                           torch.where(na, torch.nan, 1.0))
    hit = ((a != 0) & ~torch.isnan(a)) | ((b != 0) & ~torch.isnan(b))
    return torch.where(hit, 1.0, torch.where(na, torch.nan, 0.0))


def isna_expr(a):
    return torch.where(torch.isnan(a), 1.0, 0.0)


def ifelse(cond: Column, yes, no) -> Column:
    c = _as_f32(cond)
    a = _as_f32(yes) if isinstance(yes, Column) else _scalar_like(yes, c)
    b = _as_f32(no) if isinstance(no, Column) else _scalar_like(no, c)
    return Column.from_device(ifelse_expr(c, a, b).float(), T_NUM,
                              cond.nrows)


def logical(op: str, left, right) -> Column:
    a, b, ref = _operands(left, right)
    return Column.from_device(logical_expr(op, a, b).float(), T_NUM,
                              ref.nrows)


def is_na(col: Column) -> Column:
    if col.ctype == T_CAT:
        return Column.from_device((col.data < 0).float(), T_NUM, col.nrows)
    if col.data is None:
        vals = np.array([1.0 if v is None else 0.0 for v in col.host_data],
                        np.float32)
        return Column.from_numpy(vals)
    return Column.from_device(isna_expr(col.data), T_NUM, col.nrows)
