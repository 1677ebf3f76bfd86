"""Full-batch L-BFGS to optax 0.2.6's formulas (counterpart of
`optax.lbfgs()` as h2o3_tpu/models/glm.py:343-362 drives it).

`optax.lbfgs()` chains three transforms, transcribed here:
- `scale_by_lbfgs(memory_size=10, scale_init_precond=True)`
  (optax/_src/transform.py:1573, the two-loop product :1497): the last 10
  differences of parameters and gradients, the identity scaled by
  <dw, du> / <du, du> (by min(1, 1/|g|) at the first step);
- `scale(-1)`: the descent direction;
- `scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy="one")` (optax/_src/linesearch.py:576-1283,
  :1331): the interval search and zoom of Nocedal and Wright's
  algorithms 3.5 and 3.6, with the approximate-Wolfe decrease test,
  cubic, then quadratic, then bisection steps, and the safe-step
  fallback, at optax's defaults (slope_rtol 1e-4, curv_rtol 0.9,
  approx_dec_rtol 1e-6, increase factor 2, interval threshold 1e-5, tol
  0, no largest step).

The vectors stay on their device in float32; the line search's scalars
(values, slopes, steps) are float32 on the host, as optax keeps them in
float32, so each function evaluation costs one host sync. `minimize`
runs the GLM's loop: a step while `it < max_iter` and (`it == 0` or
|g| > tol), g being the gradient the line search ended on.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

F32 = np.float32
ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

# optax.lbfgs()'s settings
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = F32(1e-4)
CURV_RTOL = F32(0.9)
APPROX_DEC_RTOL = F32(1e-6)
INCREASE_FACTOR = F32(2.0)
INTERVAL_THRESHOLD = F32(1e-5)
TOL = F32(0.0)


def value_and_grad(fn: Callable[[torch.Tensor], torch.Tensor]
                   ) -> ValueAndGrad:
    """x -> (fn(x), d fn / dx) through autograd, both detached."""
    def vg(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = fn(x)
            (g,) = torch.autograd.grad(v, x)
        return v.detach(), g.detach()
    return vg


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


class _Memory:
    """scale_by_lbfgs's state: count, last params and gradient, and the
    circular buffers of differences and their weights 1/<du, dw>."""

    def __init__(self, x: torch.Tensor, m: int = MEMORY_SIZE):
        self.m = m
        self.count = 0
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.dw: List[torch.Tensor] = [torch.zeros_like(x) for _ in range(m)]
        self.du: List[torch.Tensor] = [torch.zeros_like(x) for _ in range(m)]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        self.rho: List[torch.Tensor] = [zero] * m

    def direction(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """-P g: the preconditioned gradient (transform.py:1683-1750) and
        the scale(-1) after it; updates the buffers first."""
        m, k = self.m, self.count
        idx, prev = k % m, (k - 1) % m
        if k > 0:
            dw, du = x - self.params, g - self.updates
            v = _dot(du, dw)
            rho = torch.where(v == 0, torch.zeros_like(v), 1.0 / v)
            denom = _dot(du, du)
            scale = torch.where(denom > 0, v / denom, torch.ones_like(v))
        else:
            dw, du = torch.zeros_like(x), torch.zeros_like(x)
            rho = torch.zeros((), dtype=torch.float32, device=x.device)
            scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(g), 1.0)
        self.dw[prev], self.du[prev], self.rho[prev] = dw, du, rho
        # two-loop recursion (transform.py:1497), newest pair first
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * _dot(self.dw[i], vec)
            vec = vec - alphas[i] * self.du[i]
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * _dot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.count = k + 1
        self.params, self.updates = x, g
        return -vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (linesearch.py:455); NaN when there is none."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r1 - db ** 2 * r2) / denom
    B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
    radical = B * B - F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (linesearch.py:496)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (F32(2.0) * B)


# np.maximum/np.minimum propagate NaN as jnp.maximum/jnp.minimum do
def _decrease_error(step, value, slope, value_init, slope_init):
    err = value - value_init - SLOPE_RTOL * step * slope_init
    approx = np.maximum(
        slope - (F32(2.0) * SLOPE_RTOL - F32(1.0)) * slope_init,
        value - value_init - APPROX_DEC_RTOL * abs(value_init))
    err = np.maximum(np.minimum(approx, err), F32(0.0))
    return F32(np.inf) if np.isnan(err) else F32(err)


def _curvature_error(slope, slope_init):
    err = np.maximum(abs(slope) - CURV_RTOL * abs(slope_init), F32(0.0))
    return F32(np.inf) if np.isnan(err) else F32(err)


def zoom_linesearch(vg: ValueAndGrad, x: torch.Tensor, d: torch.Tensor,
                    value_init: np.float32, grad: torch.Tensor
                    ) -> Tuple[np.float32, np.float32, torch.Tensor]:
    """-> (step, value, gradient at x + step * d), optax's zoom line
    search started from the guess 1 (linesearch.py:1194-1283)."""

    def on_line(t):
        v, g = vg(x + float(t) * d)
        vs = torch.stack([v.float().reshape(()), _dot(g, d).float()]).cpu()
        return F32(vs[0].item()), g, F32(vs[1].item())

    slope_init = F32(_dot(grad, d).item())
    s = dict(count=0, stepsize=F32(0.0), value=value_init, grad=grad,
             slope=slope_init, decrease_error=F32(np.inf), done=False,
             failed=False, interval_found=False,
             low=F32(0.0), value_low=value_init, slope_low=slope_init,
             high=F32(0.0), value_high=value_init, slope_high=slope_init,
             cubic_ref=F32(0.0), value_cubic_ref=value_init,
             safe_stepsize=F32(0.0), safe_value=value_init, safe_grad=grad)
    with np.errstate(all="ignore"):
        while not (s["done"] or s["failed"]):
            if s["interval_found"]:
                _zoom(s, on_line, value_init, slope_init)
            else:
                _search(s, on_line, value_init, slope_init)
            if s["failed"]:
                # _try_safe_step (linesearch.py:768)
                if s["safe_stepsize"] > 0.0 or np.isinf(s["decrease_error"]):
                    s["stepsize"], s["value"], s["grad"] = (
                        s["safe_stepsize"], s["safe_value"], s["safe_grad"])
    return s["stepsize"], s["value"], s["grad"]


def _search(s, on_line, value_init, slope_init):
    """Interval search, Nocedal and Wright's algorithm 3.5
    (linesearch.py:815)."""
    it = s["count"]
    prev, prev_value, prev_slope = s["stepsize"], s["value"], s["slope"]
    new = F32(1.0) if it == 0 else INCREASE_FACTOR * prev
    value, grad, slope = on_line(new)
    dec = _decrease_error(new, value, slope, value_init, slope_init)
    curv = _curvature_error(slope, slope_init)
    err = np.maximum(dec, curv)
    if dec <= TOL:
        s["safe_stepsize"], s["safe_value"], s["safe_grad"] = new, value, grad
    set_high = (dec > 0.0) or (value >= prev_value and it > 0)
    set_low = (slope >= 0.0) and not set_high
    if set_low:
        lo, hi = (new, value, slope), (prev, prev_value, prev_slope)
    else:
        lo, hi = (prev, prev_value, prev_slope), (new, value, slope)
    interval_found = set_high or set_low or err <= TOL
    done = bool(err <= TOL)
    s.update(count=it + 1, stepsize=new, value=value, grad=grad, slope=slope,
             decrease_error=dec, interval_found=interval_found, done=done,
             failed=(it + 1 >= MAX_LINESEARCH_STEPS) and not done,
             low=lo[0], value_low=lo[1], slope_low=lo[2],
             high=hi[0], value_high=hi[1], slope_high=hi[2],
             cubic_ref=lo[0], value_cubic_ref=lo[1])


def _zoom(s, on_line, value_init, slope_init):
    """Zoom into the interval, Nocedal and Wright's algorithm 3.6
    (linesearch.py:971)."""
    it = s["count"]
    low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
    high, value_high, slope_high = (s["high"], s["value_high"],
                                    s["slope_high"])
    delta = abs(high - low)
    left, right = np.minimum(high, low), np.maximum(high, low)
    cubic_chk, quad_chk = F32(0.2) * delta, F32(0.1) * delta
    too_small = delta <= INTERVAL_THRESHOLD
    mid_cubic = F32(_cubicmin(low, value_low, slope_low, high, value_high,
                              s["cubic_ref"], s["value_cubic_ref"]))
    use_cubic = bool(left + cubic_chk < mid_cubic < right - cubic_chk)
    mid_quad = F32(_quadmin(low, value_low, slope_low, high, value_high))
    use_quad = (not use_cubic) and bool(
        left + quad_chk < mid_quad < right - quad_chk)
    middle = (mid_cubic if use_cubic else mid_quad if use_quad
              else (low + high) / F32(2.0))
    value, grad, slope = on_line(middle)
    dec = _decrease_error(middle, value, slope, value_init, slope_init)
    curv = _curvature_error(slope, slope_init)
    err = np.maximum(dec, curv)
    if dec <= TOL and value < s["safe_value"]:
        s["safe_stepsize"], s["safe_value"], s["safe_grad"] = (middle, value,
                                                               grad)
    done = bool(err <= TOL)
    set_high_mid = (dec > 0.0) or (value >= value_low)
    set_high_low = (slope * (high - low) >= 0.0) and not set_high_mid
    new_high = ((middle, value, slope) if set_high_mid
                else (low, value_low, slope_low) if set_high_low
                else (high, value_high, slope_high))
    new_low = ((middle, value, slope) if not set_high_mid
               else (low, value_low, slope_low))
    cref = ((high, value_high) if (set_high_mid or set_high_low)
            else (low, value_low))
    failed = ((it + 1 >= MAX_LINESEARCH_STEPS)
              or (too_small and s["safe_stepsize"] > 0.0)) and not done
    s.update(count=it + 1, stepsize=middle, value=value, grad=grad,
             slope=slope, decrease_error=dec, done=done, failed=failed,
             low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
             high=new_high[0], value_high=new_high[1],
             slope_high=new_high[2], cubic_ref=cref[0],
             value_cubic_ref=cref[1])


def minimize(vg: ValueAndGrad, x0: torch.Tensor, max_iter: int,
             tol: float = 1e-6,
             trace: Optional[List[torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, int]:
    """The GLM's optax loop (glm.py:346-362): -> (x, iterations). The
    first step is always taken; then one while |g| > tol, g the gradient
    at the accepted step, up to max_iter. `trace`, when given, collects
    every iterate."""
    mem = _Memory(x0)
    x, value, grad, it = x0, F32(np.inf), None, 0
    while it < max_iter:
        if it > 0 and not float(torch.linalg.vector_norm(grad)) > tol:
            break
        if not np.isfinite(value):
            # value_and_grad_from_state: the stored pair unless not finite
            v, grad = vg(x)
            value = F32(v.item())
        d = mem.direction(grad, x)
        step, value, grad = zoom_linesearch(vg, x, d, value, grad)
        x = x + float(step) * d
        it += 1
        if trace is not None:
            trace.append(x)
    return x, it
