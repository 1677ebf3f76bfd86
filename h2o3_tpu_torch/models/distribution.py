"""Distribution families and link functions (counterpart of
h2o3_tpu/models/distribution.py): gaussian, bernoulli, quasibinomial,
multinomial, poisson, gamma, tweedie, laplace, quantile and huber.

Each family is a set of plain torch functions: link / inverse link,
per-row deviance, the negative half-gradient used as tree residuals, and
the numerator/denominator rows of the leaf Newton step and of the prior.
"""

from __future__ import annotations

import torch

EPS = 1e-10


def _clip01(p):
    return torch.clamp(p, EPS, 1.0 - EPS)


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
        mu = _clip01(mu)
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


class Quasibinomial(Bernoulli):
    name = "quasibinomial"

    def deviance(self, w, y, f):
        p = _clip01(self.linkinv(f))
        return -2 * w * (y * torch.log(p) + (1 - y) * torch.log(1 - p))


class Multinomial(Distribution):
    """Handled by the K-trees-per-iteration loop; link is log-odds."""

    name = "multinomial"

    def linkinv(self, f):
        return torch.exp(f)


class Poisson(Distribution):
    name = "poisson"

    def link(self, mu):
        return torch.log(torch.clamp_min(mu, EPS))

    def linkinv(self, f):
        return torch.exp(f)

    def deviance(self, w, y, f):
        mu = self.linkinv(f)
        return 2 * w * (y * torch.log(torch.clamp_min(y, EPS) / mu)
                        - (y - mu))

    def neg_half_gradient(self, y, f):
        return y - torch.exp(f)

    def gamma_denom(self, w, y, z, f):
        return w * (y - z)  # = w * exp(f)

    def init_f_num(self, w, y, o):
        return w * y

    def init_f_denom(self, w, y, o):
        return w * torch.exp(o)


class Gamma(Distribution):
    name = "gamma"

    def link(self, mu):
        return torch.log(torch.clamp_min(mu, EPS))

    def linkinv(self, f):
        return torch.exp(f)

    def deviance(self, w, y, f):
        mu = torch.clamp_min(self.linkinv(f), EPS)
        yy = torch.clamp_min(y, EPS)
        return 2 * w * (-torch.log(yy / mu) + (yy - mu) / mu)

    def neg_half_gradient(self, y, f):
        return y * torch.exp(-f) - 1

    def gamma_denom(self, w, y, z, f):
        return w * y * torch.exp(-f)

    def init_f_num(self, w, y, o):
        return w * y * torch.exp(-o)

    def init_f_denom(self, w, y, o):
        return w


class Tweedie(Distribution):
    name = "tweedie"

    def __init__(self, power: float = 1.5):
        if not 1.0 < power < 2.0:
            raise ValueError("tweedie variance power must be in (1, 2)")
        self.power = float(power)

    def link(self, mu):
        return torch.log(torch.clamp_min(mu, EPS))

    def linkinv(self, f):
        return torch.exp(f)

    def deviance(self, w, y, f):
        p = self.power
        mu = self.linkinv(f)
        return 2 * w * (torch.clamp_min(y, 0.0) ** (2 - p)
                        / ((1 - p) * (2 - p))
                        - y * mu ** (1 - p) / (1 - p)
                        + mu ** (2 - p) / (2 - p))

    def neg_half_gradient(self, y, f):
        p = self.power
        return y * torch.exp(f * (1 - p)) - torch.exp(f * (2 - p))

    def gamma_num(self, w, y, z, f):
        return w * y * torch.exp(f * (1 - self.power))

    def gamma_denom(self, w, y, z, f):
        return w * torch.exp(f * (2 - self.power))

    def init_f_num(self, w, y, o):
        return w * y * torch.exp(o * (1 - self.power))

    def init_f_denom(self, w, y, o):
        return w * torch.exp(o * (2 - self.power))


class Laplace(Distribution):
    name = "laplace"

    def deviance(self, w, y, f):
        return w * torch.abs(y - f)

    def neg_half_gradient(self, y, f):
        return torch.sign(y - f)


class Quantile(Distribution):
    name = "quantile"

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)

    def deviance(self, w, y, f):
        d = y - f
        return w * torch.where(d >= 0, self.alpha * d, (self.alpha - 1) * d)

    def neg_half_gradient(self, y, f):
        return torch.where(y > f, self.alpha, self.alpha - 1)


class Huber(Distribution):
    name = "huber"

    def __init__(self, delta: float = 1.0):
        self.delta = float(delta)

    def deviance(self, w, y, f):
        d = torch.abs(y - f)
        return w * torch.where(d <= self.delta, d ** 2,
                               2 * self.delta * d - self.delta ** 2)

    def neg_half_gradient(self, y, f):
        d = y - f
        return torch.where(torch.abs(d) <= self.delta, d,
                           self.delta * torch.sign(d))


_FAMILIES = {
    "gaussian": Gaussian, "bernoulli": Bernoulli, "binomial": Bernoulli,
    "quasibinomial": Quasibinomial, "multinomial": Multinomial,
    "poisson": Poisson, "gamma": Gamma, "laplace": Laplace,
}


def get_distribution(name: str, *, tweedie_power: float = 1.5,
                     quantile_alpha: float = 0.5) -> Distribution:
    """Family by name (huber keeps delta 1, as the reference's)."""
    name = name.lower()
    if name == "tweedie":
        return Tweedie(tweedie_power)
    if name == "quantile":
        return Quantile(quantile_alpha)
    if name == "huber":
        return Huber()
    cls = _FAMILIES.get(name)
    if cls is None:
        raise ValueError(f"unknown distribution {name!r}")
    return cls()


def auto_distribution(response_ctype: str, nclasses: int) -> str:
    """AUTO resolution: bernoulli for a 2-level enum, multinomial for more,
    gaussian otherwise."""
    if response_ctype == "enum":
        return "bernoulli" if nclasses == 2 else "multinomial"
    return "gaussian"
