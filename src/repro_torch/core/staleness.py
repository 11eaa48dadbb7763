"""Staleness distribution models (paper §IV); port of ``src/repro/core/staleness.py``.

Pure numpy float64, copied from the reference so both packages fit bit-identically.

A gradient's staleness ``tau`` is the number of SGD updates applied by *other*
workers between the moment a worker read the parameter vector and the moment
its own update is applied (eq. 4 of the paper).  The paper studies four models:

* ``Geometric(p)``     — prior work [Mitliagkas et al. 2016]; valid when the
  scheduling delay dominates (``tau_C << tau_S``).
* ``BoundedUniform(t)`` — prior work [AdaDelay, Sra et al. 2016].
* ``Poisson(lam)``      — this paper; gradient-computation completions as rare
  arrival events, ``lam ≈ m`` (number of workers).
* ``CMP(lam, nu)``      — this paper's main proposal; Conway–Maxwell–Poisson,
  eq. (12), with decay-rate parameter ``nu`` (``nu=1`` recovers Poisson).
  The mode relation ``lam**(1/nu) = m`` (eq. 13) reduces fitting to a 1-D
  search over ``nu``.

All models expose a common interface: ``pmf``, ``log_pmf``, ``sample``,
``mean``, ``mode``, and classmethod fitters (MLE where cheap, plus the paper's
Bhattacharyya-distance exhaustive search used for Table I).

Everything here is host-side math (numpy, float64) — the device-facing artifact
is the step-size *table* built in :mod:`repro_torch.core.step_size`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "StalenessModel",
    "Geometric",
    "BoundedUniform",
    "Poisson",
    "CMP",
    "bhattacharyya_distance",
    "empirical_pmf",
    "fit_all_models",
    "MODEL_REGISTRY",
]


# Host-side numpy distribution math: pmf tables are computed once when a step
# is built and enter the tick as device tables — nothing here runs inside the tick.
# reprolint: disable-file=RL001


def _as_int_array(k) -> np.ndarray:
    k = np.asarray(k)
    if not np.issubdtype(k.dtype, np.integer):
        k = k.astype(np.int64)
    return k


@dataclasses.dataclass(frozen=True)
class StalenessModel:
    """Base class for staleness distributions over the non-negative integers."""

    def log_pmf(self, k) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def pmf(self, k) -> np.ndarray:
        return np.exp(self.log_pmf(k))

    def pmf_table(self, tau_max: int) -> np.ndarray:
        """``P[tau = i]`` for ``i in [0, tau_max]`` (not renormalized)."""
        return self.pmf(np.arange(tau_max + 1))

    def mean(self) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def mode(self) -> int:
        tab = self.pmf_table(max(int(self.mean() * 4) + 32, 64))
        return int(np.argmax(tab))

    def sample(self, rng: np.random.Generator, shape=()) -> np.ndarray:
        """Inverse-CDF sampling from the (truncated, renormalized) pmf."""
        tau_max = max(int(self.mean() * 8) + 64, 256)
        tab = self.pmf_table(tau_max)
        tab = tab / tab.sum()
        cdf = np.cumsum(tab)
        u = rng.random(shape)
        return np.searchsorted(cdf, u).astype(np.int64)

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Geometric(StalenessModel):
    """``P[tau = k] = p (1-p)^k`` for ``k >= 0`` (paper Thm 2/3 model)."""

    p: float

    def __post_init__(self):
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"geometric parameter p must be in (0, 1], got {self.p}")

    def log_pmf(self, k) -> np.ndarray:
        k = _as_int_array(k)
        out = math.log(self.p) + k * math.log1p(-self.p) if self.p < 1.0 else np.where(k == 0, 0.0, -np.inf)
        out = np.where(k < 0, -np.inf, out)
        return np.asarray(out, dtype=np.float64)

    def mean(self) -> float:
        return (1.0 - self.p) / self.p

    def mode(self) -> int:
        return 0

    def sample(self, rng: np.random.Generator, shape=()) -> np.ndarray:
        # numpy's geometric is over {1, 2, ...}; the paper's support is {0, 1, ...}
        return rng.geometric(self.p, size=shape) - 1

    @classmethod
    def fit_mle(cls, taus: np.ndarray) -> "Geometric":
        m = float(np.mean(taus))
        return cls(p=1.0 / (1.0 + m))


@dataclasses.dataclass(frozen=True)
class BoundedUniform(StalenessModel):
    """``P[tau = k] = 1/(tau_hat+1)`` for ``0 <= k <= tau_hat`` (AdaDelay model)."""

    tau_hat: int

    def __post_init__(self):
        if self.tau_hat < 0:
            raise ValueError("tau_hat must be >= 0")

    def log_pmf(self, k) -> np.ndarray:
        k = _as_int_array(k)
        inside = (k >= 0) & (k <= self.tau_hat)
        return np.where(inside, -math.log(self.tau_hat + 1), -np.inf).astype(np.float64)

    def mean(self) -> float:
        return self.tau_hat / 2.0

    def mode(self) -> int:
        return 0

    def sample(self, rng: np.random.Generator, shape=()) -> np.ndarray:
        return rng.integers(0, self.tau_hat + 1, size=shape)

    @classmethod
    def fit_mle(cls, taus: np.ndarray) -> "BoundedUniform":
        return cls(tau_hat=int(np.max(taus)))


@dataclasses.dataclass(frozen=True)
class Poisson(StalenessModel):
    """``P[tau = k] = e^{-lam} lam^k / k!`` — CMP with ``nu = 1``."""

    lam: float

    def __post_init__(self):
        if self.lam <= 0:
            raise ValueError("lam must be > 0")

    def log_pmf(self, k) -> np.ndarray:
        k = _as_int_array(k)
        kk = np.maximum(k, 0).astype(np.float64)
        out = -self.lam + kk * math.log(self.lam) - _lgamma(kk + 1.0)
        return np.where(k < 0, -np.inf, out)

    def mean(self) -> float:
        return self.lam

    def mode(self) -> int:
        return int(math.floor(self.lam))

    def sample(self, rng: np.random.Generator, shape=()) -> np.ndarray:
        return rng.poisson(self.lam, size=shape)

    @classmethod
    def fit_mle(cls, taus: np.ndarray) -> "Poisson":
        return cls(lam=max(float(np.mean(taus)), 1e-9))


def _lgamma(x: np.ndarray) -> np.ndarray:
    return np.vectorize(math.lgamma, otypes=[np.float64])(x)


@dataclasses.dataclass(frozen=True)
class CMP(StalenessModel):
    """Conway–Maxwell–Poisson, eq. (12):

    ``P[tau = i] = lam^i / (i!)^nu / Z(lam, nu)``.

    ``nu`` controls the decay rate; ``nu = 1`` is Poisson.  The mode is
    ``floor(lam^(1/nu))`` so the paper hypothesizes ``lam^(1/nu) = m``
    (eq. 13): given the worker count, only ``nu`` needs fitting.
    """

    lam: float
    nu: float
    _z_terms: int = 4096  # truncation for the normalizer series

    def __post_init__(self):
        if self.lam <= 0:
            raise ValueError("lam must be > 0")
        if self.nu <= 0:
            raise ValueError("nu must be > 0 (nu -> 0 has heavy, non-normalizable tails for lam >= 1)")

    def _log_terms(self, k: np.ndarray) -> np.ndarray:
        kk = np.maximum(k, 0).astype(np.float64)
        return kk * math.log(self.lam) - self.nu * _lgamma(kk + 1.0)

    def log_z(self) -> float:
        js = np.arange(self._z_terms)
        terms = self._log_terms(js)
        mx = float(np.max(terms))
        return mx + math.log(float(np.sum(np.exp(terms - mx))))

    def log_pmf(self, k) -> np.ndarray:
        k = _as_int_array(k)
        out = self._log_terms(k) - self.log_z()
        return np.where(k < 0, -np.inf, out)

    def mean(self) -> float:
        tau_max = max(int(self.lam ** (1.0 / self.nu)) * 4 + 64, 256)
        ks = np.arange(tau_max + 1)
        p = self.pmf(ks)
        p = p / p.sum()
        return float(np.sum(ks * p))

    def mode(self) -> int:
        return int(math.floor(self.lam ** (1.0 / self.nu)))

    @classmethod
    def from_mode(cls, m: int, nu: float) -> "CMP":
        """Apply the mode relation (13): ``lam = m^nu``."""
        return cls(lam=float(m) ** nu, nu=nu)

    @classmethod
    def fit_mode_relation(
        cls,
        taus_or_pmf: np.ndarray,
        m: int,
        nus: Sequence[float] | None = None,
        *,
        is_pmf: bool = False,
    ) -> "CMP":
        """Paper's Table-I fit: 1-D search over ``nu`` with ``lam = m^nu``,
        minimizing the Bhattacharyya distance to the observed distribution."""
        q = np.asarray(taus_or_pmf, dtype=np.float64) if is_pmf else empirical_pmf(taus_or_pmf)
        if nus is None:
            nus = np.concatenate([np.linspace(0.05, 2.0, 79), np.linspace(2.05, 8.0, 120)])
        best, best_d = None, np.inf
        for nu in nus:
            cand = cls.from_mode(m, float(nu))
            d = bhattacharyya_distance(q, cand.pmf_table(len(q) - 1))
            if d < best_d:
                best, best_d = cand, d
        assert best is not None
        return best


def empirical_pmf(taus: np.ndarray, tau_max: int | None = None) -> np.ndarray:
    """Histogram of observed staleness values, normalized to a pmf."""
    taus = np.asarray(taus).astype(np.int64)
    if taus.size == 0:
        raise ValueError("no staleness observations")
    hi = int(taus.max()) if tau_max is None else tau_max
    counts = np.bincount(np.clip(taus, 0, hi), minlength=hi + 1).astype(np.float64)
    return counts / counts.sum()


def bhattacharyya_distance(p: np.ndarray, q: np.ndarray) -> float:
    """``D_B(p, q) = -ln sum_i sqrt(p_i q_i)`` over the common (padded) support.

    Both inputs are renormalized over the padded support so model tails beyond
    the observation range are accounted for consistently (paper §VI)."""
    n = max(len(p), len(q))
    pp = np.zeros(n, dtype=np.float64)
    qq = np.zeros(n, dtype=np.float64)
    pp[: len(p)] = p
    qq[: len(q)] = q
    pp = pp / pp.sum()
    qq = qq / qq.sum()
    bc = float(np.sum(np.sqrt(pp * qq)))
    bc = min(max(bc, 1e-300), 1.0)
    return -math.log(bc)


def _fit_by_search(
    make: Callable[[float], StalenessModel],
    grid: np.ndarray,
    q: np.ndarray,
) -> StalenessModel:
    best, best_d = None, np.inf
    for g in grid:
        try:
            cand = make(float(g))
        except ValueError:
            continue
        d = bhattacharyya_distance(q, cand.pmf_table(len(q) - 1))
        if d < best_d:
            best, best_d = cand, d
    assert best is not None
    return best


def fit_all_models(taus: np.ndarray, m: int) -> dict[str, tuple[StalenessModel, float]]:
    """Reproduce the paper's Table I: fit each model family to observed ``taus``
    by minimizing the Bhattacharyya distance; return {name: (model, distance)}.
    """
    q = empirical_pmf(taus)
    n = len(q)
    fits: dict[str, tuple[StalenessModel, float]] = {}

    geo = _fit_by_search(lambda p: Geometric(p), np.linspace(0.005, 0.995, 199), q)
    uni = _fit_by_search(lambda t: BoundedUniform(int(round(t))), np.arange(0, max(4 * m, n) + 1), q)
    poi = _fit_by_search(
        lambda lam: Poisson(lam), np.linspace(max(0.05, 0.25 * m), 4.0 * m + 1.0, 400), q
    )
    cmp_ = CMP.fit_mode_relation(q, m, is_pmf=True)

    for mdl in (geo, uni, poi, cmp_):
        fits[mdl.name] = (mdl, bhattacharyya_distance(q, mdl.pmf_table(n - 1)))
    return fits


MODEL_REGISTRY = {
    "geometric": Geometric,
    "uniform": BoundedUniform,
    "poisson": Poisson,
    "cmp": CMP,
}
