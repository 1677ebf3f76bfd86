"""Distribution families and link functions (counterpart of
h2o3_tpu/models/distribution.py). This slice ports the single-margin
families GBM's flagship uses: gaussian and bernoulli.

Each family is a set of plain torch functions: link / inverse link,
per-row deviance, the negative half-gradient used as tree residuals, and
the numerator/denominator rows of the leaf Newton step and of the prior.
"""

from __future__ import annotations

import torch

EPS = 1e-10


class Distribution:
    """Base family. f = link-space prediction ("margin"), y = response."""

    name = "gaussian"

    def link(self, mu):
        return mu

    def linkinv(self, f):
        return f

    def deviance(self, w, y, f):
        raise NotImplementedError

    def neg_half_gradient(self, y, f):
        raise NotImplementedError

    def gamma_num(self, w, y, z, f):
        return w * z

    def gamma_denom(self, w, y, z, f):
        return w

    def init_f_num(self, w, y, o):
        return w * (y - o)

    def init_f_denom(self, w, y, o):
        return w


class Gaussian(Distribution):
    name = "gaussian"

    def deviance(self, w, y, f):
        return w * (y - f) ** 2

    def neg_half_gradient(self, y, f):
        return y - f


class Bernoulli(Distribution):
    name = "bernoulli"

    def link(self, mu):
        mu = torch.clamp(mu, EPS, 1.0 - EPS)
        return torch.log(mu / (1 - mu))

    def linkinv(self, f):
        return 1.0 / (1.0 + torch.exp(-f))

    def deviance(self, w, y, f):
        return -2 * w * (y * f - torch.logaddexp(torch.zeros_like(f), f))

    def neg_half_gradient(self, y, f):
        return y - self.linkinv(f)

    def gamma_denom(self, w, y, z, f):
        p = y - z  # p = linkinv(f) was subtracted to make z
        return w * p * (1 - p)

    def init_f_num(self, w, y, o):
        return w * y

    def init_f_denom(self, w, y, o):
        return w * 1.0


_FAMILIES = {"gaussian": Gaussian, "bernoulli": Bernoulli,
             "binomial": Bernoulli}


def get_distribution(name: str) -> Distribution:
    """Family by name. Families beyond gaussian/bernoulli are not ported
    yet and raise NotImplementedError."""
    cls = _FAMILIES.get(name.lower())
    if cls is None:
        raise NotImplementedError(f"distribution {name!r} is not ported yet "
                                  "(gaussian, bernoulli)")
    return cls()


def auto_distribution(response_ctype: str, nclasses: int) -> str:
    """AUTO resolution: bernoulli for a 2-level enum, multinomial for more,
    gaussian otherwise."""
    if response_ctype == "enum":
        return "bernoulli" if nclasses == 2 else "multinomial"
    return "gaussian"
