"""BFGS to jax's formulas (counterpart of
`jax.scipy.optimize.minimize(method="BFGS")` as h2o3_tpu/models/psvm.py
:137-146 drives it).

jax's BFGS (jax/_src/scipy/optimize/bfgs.py, Nocedal and Wright's
algorithm 6.1), transcribed:
- start from H = I, stop when the gradient's largest |entry| is below
  gtol (1e-5), a line search fails, or after maxiter steps;
- a step searches along p = -H g, moves to x + a p, and updates H to
  (I - ρ s yᵀ) H (I - ρ y sᵀ) + ρ s sᵀ with ρ = 1 / yᵀs (H is kept when
  ρ is not finite);
- the line search (jax/_src/scipy/optimize/line_search.py, algorithms
  3.5 and 3.6) brackets a step meeting the strong Wolfe conditions (c1
  1e-4, c2 0.9), starting at min(1, 2.02 (f - f_prev) / slope) and
  doubling, at most 10 times; its zoom tries the cubic minimiser (from
  the second try on), then the quadratic one, then bisection, and fails
  when the interval falls to 1e-5 or after 30 tries. A step below 1e-8
  is raised to 1e-8.

The vectors stay on their device; the scalars (values, slopes, steps)
are host numbers of the vectors' precision (float32 for float32, as
jax keeps them, float64 for float64, where the zoom's interval floor is
1e-10 and small steps are not raised), so each function evaluation
costs one host sync.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

F32 = np.float32
ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

C1, C2 = 1e-4, 0.9
ZOOM_DELTA1, ZOOM_DELTA2 = 0.2, 0.1
ZOOM_MAX_TRIES = 30
LINE_SEARCH_MAXITER = 10
GTOL = 1e-5


class BFGSResult(NamedTuple):
    x: torch.Tensor
    fun: float
    converged: bool
    failed: bool
    nit: int
    nfev: int


def value_and_grad(fun: Callable[[torch.Tensor], torch.Tensor]
                   ) -> ValueAndGrad:
    """(value, gradient) of a scalar function of one vector, by
    torch.func."""
    gv = torch.func.grad_and_value(fun)

    def fg(x):
        g, f = gv(x)
        return f, g
    return fg


def _cubicmin(F, a, fa, fpa, b, fb, c, fc):
    """Minimiser of the cubic through (a, fa) with slope fpa, (b, fb)
    and (c, fc); NaN when it has none."""
    with np.errstate(all="ignore"):
        C = fpa
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        d1 = np.array([[dc ** 2, -db ** 2], [-dc ** 3, db ** 3]], F)
        d2 = np.array([fb - fa - C * db, fc - fa - C * dc], F)
        A, B = (d1 @ d2) / denom
        radical = B * B - F(3.0) * A * C
        return F(a + (-B + np.sqrt(radical)) / (F(3.0) * A))


def _quadmin(F, a, fa, fpa, b, fb):
    """Minimiser of the quadratic through (a, fa) with slope fpa and (b,
    fb)."""
    with np.errstate(all="ignore"):
        db = b - a
        B = (fb - fa - fpa * db) / (db ** 2)
        return F(a - fpa / (F(2.0) * B))


class _Searcher:
    """One line search along pk from xk (value phi_0, gradient gfk), its
    scalars of type F."""

    def __init__(self, fg: ValueAndGrad, xk, pk, phi_0, gfk):
        self.F = F = np.float64 if pk.dtype == torch.float64 else F32
        self.fg, self.xk, self.pk = fg, xk, pk
        self.phi_0, self.dphi_0 = phi_0, self.dot(gfk, pk)
        self.c1, self.c2 = F(C1), F(C2)
        self.threshold = F(1e-10 if F is np.float64 else 1e-5)
        self.nfev = 0

    def dot(self, a: torch.Tensor, b: torch.Tensor):
        return self.F(torch.dot(a, b).item())

    def eval(self, t):
        f, g = self.fg(self.xk + float(t) * self.pk)
        self.nfev += 1
        return self.F(f.item()), self.dot(g, self.pk), g

    def wolfe_one(self, a, phi):
        return phi > self.phi_0 + self.c1 * a * self.dphi_0

    def wolfe_two(self, dphi):
        return abs(dphi) <= -self.c2 * self.dphi_0

    def zoom(self, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi, g_0):
        """-> (failed, a_star, phi_star, g_star)."""
        F = self.F
        a_rec = (a_lo + a_hi) / F(2.0)
        phi_rec = (phi_lo + phi_hi) / F(2.0)
        star = (F(1.0), phi_lo, g_0)
        failed, j = False, 0
        while True:
            dalpha = a_hi - a_lo
            a, b = min(a_hi, a_lo), max(a_hi, a_lo)
            cchk, qchk = F(ZOOM_DELTA1) * dalpha, F(ZOOM_DELTA2) * dalpha
            failed = failed or dalpha <= self.threshold
            a_c = _cubicmin(F, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                            phi_rec)
            use_cubic = j > 0 and a + cchk < a_c < b - cchk
            a_q = _quadmin(F, a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
            use_quad = not use_cubic and a + qchk < a_q < b - qchk
            a_j = (a_c if use_cubic else a_q if use_quad
                   else (a_lo + a_hi) / F(2.0))
            phi_j, dphi_j, g_j = self.eval(a_j)
            hi_to_j = self.wolfe_one(a_j, phi_j) or phi_j >= phi_lo
            star_to_j = self.wolfe_two(dphi_j) and not hi_to_j
            hi_to_lo = (dphi_j * (a_hi - a_lo) >= 0 and not hi_to_j
                        and not star_to_j)
            lo_to_j = not hi_to_j and not star_to_j
            done = star_to_j
            if hi_to_j:
                a_rec, phi_rec = a_hi, phi_hi
                a_hi, phi_hi, dphi_hi = a_j, phi_j, dphi_j
            if star_to_j:
                star = (a_j, phi_j, g_j)
            if hi_to_lo:
                a_rec, phi_rec = a_hi, phi_hi
                a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
            elif lo_to_j:
                a_rec, phi_rec = a_lo, phi_lo
            if lo_to_j:
                a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
            j += 1
            failed = failed or j >= ZOOM_MAX_TRIES
            if done or failed:
                return failed, *star


def line_search(fg: ValueAndGrad, xk, pk, old_fval, old_old_fval, gfk,
                maxiter: int = LINE_SEARCH_MAXITER):
    """-> (failed, step, value, gradient at xk + step pk, evaluations)."""
    s = _Searcher(fg, xk, pk, old_fval, gfk)
    F, phi_0, dphi_0 = s.F, s.phi_0, s.dphi_0
    with np.errstate(all="ignore"):
        cand = F(1.01) * F(2.0) * (phi_0 - old_old_fval) / dphi_0
    start = F(1.0) if cand > 1 else cand
    done = failed = False
    a_i1, phi_i1, dphi_i1 = F(0.0), phi_0, dphi_0
    star = (F(0.0), phi_0, gfk)
    i = 1
    while not done and i <= maxiter and not failed:
        a_i = start if i == 1 else a_i1 * F(2.0)
        phi_i, dphi_i, g_i = s.eval(a_i)
        to_zoom1 = s.wolfe_one(a_i, phi_i) or (phi_i >= phi_i1 and i > 1)
        to_i = s.wolfe_two(dphi_i) and not to_zoom1
        to_zoom2 = dphi_i >= 0 and not to_zoom1 and not to_i
        if to_zoom1:
            zf, *star = s.zoom(a_i1, phi_i1, dphi_i1, a_i, phi_i, dphi_i,
                               gfk)
            done, failed = True, failed or zf
        elif to_i:
            done, star = True, (a_i, phi_i, g_i)
        elif to_zoom2:
            zf, *star = s.zoom(a_i, phi_i, dphi_i, a_i1, phi_i1, dphi_i1,
                               gfk)
            done, failed = True, failed or zf
        i += 1
        a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
    a_k, phi_k, g_k = star
    if F is F32 and abs(a_k) < 1e-8:
        a_k = F32(np.sign(a_k) * F32(1e-8))
    return failed or not done, a_k, phi_k, g_k, s.nfev


def minimize(fg: ValueAndGrad, x0: torch.Tensor, maxiter: int = None,
             gtol: float = GTOL) -> BFGSResult:
    """Minimise the function whose (value, gradient) `fg` gives, from
    x0 (float32 or float64, on its device)."""
    F = np.float64 if x0.dtype == torch.float64 else F32
    d = x0.shape[0]
    if maxiter is None:
        maxiter = d * 200
    H = torch.eye(d, dtype=x0.dtype, device=x0.device)
    f, g = fg(x0)
    nfev = 1
    f = F(f.item())
    x = x0
    converged = float(torch.max(torch.abs(g))) < gtol
    old_old = F(f + F(torch.linalg.norm(g).item()) / F(2.0))
    failed, k = False, 0
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    while not converged and not failed and k < maxiter:
        p = -(H @ g)
        failed, a_k, f1, g1, ne = line_search(fg, x, p, f, old_old, g)
        nfev += ne
        s = float(a_k) * p
        y = g1 - g
        rho = torch.reciprocal(torch.dot(y, s))
        w = eye - rho * (s[:, None] * y[None, :])
        Hn = w @ H @ w.T + rho * (s[:, None] * s[None, :])
        H = torch.where(torch.isfinite(rho), Hn, H)
        converged = float(torch.max(torch.abs(g1))) < gtol
        k += 1
        x, old_old, f, g = x + s, f, f1, g1
    return BFGSResult(x=x, fun=float(f), converged=converged, failed=failed,
                      nit=k, nfev=nfev)
