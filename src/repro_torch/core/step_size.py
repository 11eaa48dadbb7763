"""Staleness-adaptive step-size strategies (paper §IV.B); port of
``src/repro/core/step_size.py`` (numpy float64, copied; only the device
table is torch).

The MindTheStep framework "modularizes" the step size as a function
``alpha(tau)`` of the observed staleness.  This module implements every
strategy derived in the paper plus the baselines it compares against:

* ``constant``            — standard AsyncPSGD, ``alpha(tau) = alpha_c``.
* ``geometric_momentum``  — Thm 3 / Cor 1: ``alpha(tau) = C^{-tau} p^{-1} alpha``
  which induces implicit momentum ``mu = 2 - (1-p)/C``; any target ``mu*`` via
  ``C = (1-p)/(2-mu*)`` (eq. 9–11).
* ``cmp_zeroing``         — Thm 4: ``alpha(tau) = C lam^{-tau} (tau!)^nu alpha``
  cancels the stale-gradient series ``Sigma_{p,alpha}^grad`` exactly (eq. 14).
* ``cmp_momentum``        — Thm 5: ``alpha(tau) = c(tau) lam^{-tau} (tau!)^nu alpha``
  with ``c(tau) = 1 - K/(alpha e^lam) sum_{j<tau} lam^j/(j!)^nu`` (eq. 15–16)
  turning the series into implicit momentum of magnitude exactly ``K``.
* ``poisson_momentum``    — Cor 2 (nu = 1): ``c(tau) = 1 - (K/alpha) *
  Gamma(tau, lam)/Gamma(tau)`` — O(1) via the regularized upper incomplete
  gamma function (eq. 17).
* ``adadelay``            — baseline from [Sra et al. 2016]: ``alpha/(1 + tau)``-style decay.
* ``inverse_tau``         — staleness-aware baseline [Zhang et al. IJCAI'16]: ``alpha/max(tau,1)``.

All strategies are materialized as a **table** ``alpha_table[tau]`` for
``tau in [0, tau_max]`` (float64 on host, gathered on the device as f32).  The paper's
experimental protocol (§VI) additionally
  (a) *normalizes* the table so ``E_tau[alpha(tau)] = alpha_c`` under the
      observed staleness distribution (eq. 26 — the fair-comparison constraint),
  (b) *clips* at ``clip_factor * alpha_c`` (paper uses 5x) for numerical
      stability, and
  (c) *drops* gradients with ``tau > tau_drop`` (paper uses 150) by assigning
      them a zero step.
Those are exposed as composable transforms on the table.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.staleness import CMP, Geometric, Poisson, StalenessModel, _lgamma

__all__ = [
    "StepSizeSchedule",
    "constant",
    "geometric_momentum",
    "C_for_target_momentum",
    "implicit_momentum_geometric",
    "cmp_zeroing",
    "cmp_momentum",
    "poisson_momentum",
    "adadelay",
    "inverse_tau",
    "normalize_expectation",
    "clip_table",
    "drop_above",
    "make_schedule",
    "STRATEGIES",
]


@dataclasses.dataclass(frozen=True)
class StepSizeSchedule:
    """A staleness-adaptive step size, materialized as a lookup table.

    ``table[tau]`` holds ``alpha(tau)`` for ``tau in [0, tau_max]``; queries
    beyond ``tau_max`` return ``table[-1]`` (which is 0 when ``drop_above``
    was applied, matching the paper's drop rule).
    """

    table: np.ndarray  # float64, shape (tau_max + 1,)
    name: str = "custom"

    @property
    def tau_max(self) -> int:
        return len(self.table) - 1

    @functools.cached_property
    def device_table(self) -> torch.Tensor:
        """The f32 table as a torch tensor, built ONCE per schedule (the
        schedule is frozen, so the cache can never go stale).  It lives on the
        CPU; :meth:`__call__` moves it to the device of the taus it gathers."""
        return torch.as_tensor(self.table, dtype=torch.float32)

    def __call__(self, tau):
        """Gather ``alpha(tau)`` for an int tensor (or int) ``tau``."""
        tau = torch.as_tensor(tau)
        table = self.device_table.to(tau.device)
        return table[tau.long().clamp(0, self.tau_max)]

    def alpha_np(self, tau) -> np.ndarray:
        idx = np.clip(np.asarray(tau, dtype=np.int64), 0, self.tau_max)
        return self.table[idx]

    def expectation(self, pmf: np.ndarray) -> float:
        """``E_tau[alpha(tau)]`` under a pmf over [0, len(pmf))."""
        n = min(len(pmf), len(self.table))
        w = np.asarray(pmf[:n], dtype=np.float64)
        return float(np.sum(w * self.table[:n]) / np.sum(pmf))

    def second_moment(self, pmf: np.ndarray) -> float:
        n = min(len(pmf), len(self.table))
        w = np.asarray(pmf[:n], dtype=np.float64)
        return float(np.sum(w * self.table[:n] ** 2) / np.sum(pmf))

    def tau_alpha_expectation(self, pmf: np.ndarray) -> float:
        """``E[tau * alpha(tau)]`` — appears in the Thm 6 bound."""
        n = min(len(pmf), len(self.table))
        w = np.asarray(pmf[:n], dtype=np.float64)
        ks = np.arange(n, dtype=np.float64)
        return float(np.sum(w * ks * self.table[:n]) / np.sum(pmf))


# ---------------------------------------------------------------------------
# Strategy constructors (paper equations)
# ---------------------------------------------------------------------------

def constant(alpha_c: float, tau_max: int = 256) -> StepSizeSchedule:
    """Standard AsyncPSGD baseline."""
    return StepSizeSchedule(np.full(tau_max + 1, float(alpha_c)), name="constant")


def implicit_momentum_geometric(p: float, C: float) -> float:
    """Thm 3, eq. (10): ``mu_{C,p} = 2 - (1-p)/C``."""
    return 2.0 - (1.0 - p) / C


def C_for_target_momentum(p: float, mu_star: float) -> float:
    """Cor 1, eq. (11): ``C = (1-p)/(2-mu*)`` induces momentum ``mu*``."""
    if mu_star >= 2.0:
        raise ValueError("target momentum must be < 2")
    return (1.0 - p) / (2.0 - mu_star)


def geometric_momentum(
    alpha: float, p: float, mu_star: float = 0.0, tau_max: int = 256
) -> StepSizeSchedule:
    """Thm 3 / Cor 1: ``alpha(tau) = C^{-tau} p^{-1} alpha`` (eq. 9) with C from (11).

    ``mu_star = 0`` cancels the asynchrony-induced momentum entirely
    (the ``C = (1-p)/2`` special case noted after Thm 3).
    """
    C = C_for_target_momentum(p, mu_star)
    taus = np.arange(tau_max + 1, dtype=np.float64)
    # exp(-tau log C) / p * alpha, in log space for stability.
    log_tab = -taus * math.log(C) - math.log(p) + math.log(alpha)
    return StepSizeSchedule(np.exp(np.minimum(log_tab, 700.0)), name="geometric_momentum")


def _cmp_core_log(taus: np.ndarray, lam: float, nu: float) -> np.ndarray:
    """``log( lam^{-tau} (tau!)^nu )``."""
    return -taus * math.log(lam) + nu * _lgamma(taus + 1.0)


def cmp_zeroing(
    alpha: float, lam: float, nu: float, C: float = 1.0, tau_max: int = 256
) -> StepSizeSchedule:
    """Thm 4, eq. (14): ``alpha(tau) = C lam^{-tau} (tau!)^nu alpha`` → Sigma = 0."""
    taus = np.arange(tau_max + 1, dtype=np.float64)
    log_tab = math.log(C) + _cmp_core_log(taus, lam, nu) + math.log(alpha)
    return StepSizeSchedule(np.exp(np.minimum(log_tab, 700.0)), name="cmp_zeroing")


def cmp_momentum(
    alpha: float, lam: float, nu: float, K: float, tau_max: int = 256
) -> StepSizeSchedule:
    """Thm 5, eq. (15)–(16): implicit momentum of magnitude exactly ``K``.

    ``c(tau) = 1 - K/(alpha e^lam) * S(tau)``, ``S(tau) = sum_{j=0}^{tau-1} lam^j/(j!)^nu``.
    The O(tau) prefix sum is precomputed once into the table (the paper notes
    the Poisson case collapses it to incomplete-gamma calls — see
    :func:`poisson_momentum`).
    """
    taus = np.arange(tau_max + 1, dtype=np.float64)
    log_terms = taus * math.log(lam) - nu * _lgamma(taus + 1.0)
    # prefix sums S(tau) = sum_{j < tau}; S(0) = 0 -> c(0) = 1 (alpha(0) = alpha).
    terms = np.exp(log_terms)
    S = np.concatenate([[0.0], np.cumsum(terms)[:-1]])
    c = 1.0 - (K / (alpha * math.exp(min(lam, 700.0)))) * S
    core = np.exp(np.minimum(_cmp_core_log(taus, lam, nu), 700.0))
    return StepSizeSchedule(c * core * alpha, name="cmp_momentum")


def poisson_momentum(
    alpha: float, lam: float, K: float, tau_max: int = 256
) -> StepSizeSchedule:
    """Cor 2, eq. (17): ``alpha(tau) = (1 - (K/alpha) Gamma(tau,lam)/Gamma(tau)) lam^{-tau} tau! alpha``.

    ``Gamma(tau, lam)/Gamma(tau)`` is the *regularized* upper incomplete gamma
    ``Q(tau, lam)`` , an O(1) evaluation — the
    paper's scalability argument for the Poisson model.  ``c(0) = 1`` by
    definition (empty prefix sum in eq. 16).
    """
    taus = np.arange(tau_max + 1, dtype=np.float64)
    # Q(tau, lam) = Gamma(tau, lam)/Gamma(tau) is, for integer tau, exactly the
    # Poisson(lam) CDF at tau-1:  Q(tau, lam) = e^{-lam} sum_{j<tau} lam^j/j!.
    # The table is built with the exact float64 prefix sum (the gammaincc
    # identity is cross-checked in the reference's tests).
    log_terms = taus * math.log(lam) - _lgamma(taus + 1.0) - lam
    S = np.concatenate([[0.0], np.cumsum(np.exp(log_terms))[:-1]])
    c = 1.0 - (K / alpha) * S
    c[0] = 1.0  # empty prefix sum in eq. (16)
    core = np.exp(np.minimum(_cmp_core_log(taus, lam, 1.0), 700.0))
    return StepSizeSchedule(c * core * alpha, name="poisson_momentum")


def adadelay(alpha: float, tau_max: int = 256) -> StepSizeSchedule:
    """AdaDelay-style baseline [29]: step scaled ~ ``1/(1+tau)``."""
    taus = np.arange(tau_max + 1, dtype=np.float64)
    return StepSizeSchedule(alpha / (1.0 + taus), name="adadelay")


def inverse_tau(alpha: float, tau_max: int = 256) -> StepSizeSchedule:
    """Staleness-aware baseline [Zhang et al. 2016]: ``alpha/max(tau, 1)``."""
    taus = np.maximum(np.arange(tau_max + 1, dtype=np.float64), 1.0)
    return StepSizeSchedule(alpha / taus, name="inverse_tau")


# ---------------------------------------------------------------------------
# Table transforms: the paper's experimental protocol (§VI)
# ---------------------------------------------------------------------------

def normalize_expectation(
    sched: StepSizeSchedule, pmf: np.ndarray, alpha_c: float
) -> StepSizeSchedule:
    """Eq. (26): rescale so ``E_tau[alpha(tau)] = alpha_c`` under the observed
    staleness pmf — ensures speedups come from *adaptivity*, not magnitude."""
    e = sched.expectation(pmf)
    if e <= 0:
        raise ValueError(f"cannot normalize schedule with E[alpha] = {e}")
    return StepSizeSchedule(sched.table * (alpha_c / e), name=sched.name + "+norm")


def clip_table(sched: StepSizeSchedule, alpha_c: float, clip_factor: float = 5.0) -> StepSizeSchedule:
    """Paper §VI: bound ``alpha(tau) <= clip_factor * alpha_c`` (default 5x)."""
    return StepSizeSchedule(
        np.clip(sched.table, 0.0, clip_factor * alpha_c), name=sched.name + "+clip"
    )


def drop_above(sched: StepSizeSchedule, tau_drop: int = 150) -> StepSizeSchedule:
    """Paper §VI: gradients with ``tau > tau_drop`` are not applied (zero step)."""
    tab = sched.table.copy()
    tab[tau_drop + 1 :] = 0.0
    return StepSizeSchedule(tab, name=sched.name + "+drop")


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

STRATEGIES = (
    "constant",
    "geometric_momentum",
    "cmp_zeroing",
    "cmp_momentum",
    "poisson_momentum",
    "adadelay",
    "inverse_tau",
)


def make_schedule(
    strategy: str,
    alpha_c: float,
    model: StalenessModel | None = None,
    *,
    K: float = 1.0,
    mu_star: float = 0.0,
    tau_max: int = 256,
    normalize_pmf: np.ndarray | None = None,
    clip_factor: float | None = 5.0,
    tau_drop: int | None = 150,
) -> StepSizeSchedule:
    """Build a schedule per the paper's experimental protocol.

    The paper's Fig-3 configuration is
    ``make_schedule("poisson_momentum", alpha_c, Poisson(lam=m), K=1.0,
    normalize_pmf=observed_pmf)``.
    """
    if strategy == "constant":
        sched = constant(alpha_c, tau_max)
    elif strategy == "geometric_momentum":
        assert isinstance(model, Geometric), "geometric_momentum needs a Geometric model"
        sched = geometric_momentum(alpha_c, model.p, mu_star, tau_max)
    elif strategy == "cmp_zeroing":
        assert isinstance(model, (CMP, Poisson))
        lam, nu = (model.lam, getattr(model, "nu", 1.0))
        sched = cmp_zeroing(alpha_c, lam, nu, tau_max=tau_max)
    elif strategy == "cmp_momentum":
        assert isinstance(model, (CMP, Poisson))
        lam, nu = (model.lam, getattr(model, "nu", 1.0))
        sched = cmp_momentum(alpha_c, lam, nu, K, tau_max)
    elif strategy == "poisson_momentum":
        assert isinstance(model, Poisson), "poisson_momentum needs a Poisson model"
        sched = poisson_momentum(alpha_c, model.lam, K, tau_max)
    elif strategy == "adadelay":
        sched = adadelay(alpha_c, tau_max)
    elif strategy == "inverse_tau":
        sched = inverse_tau(alpha_c, tau_max)
    else:
        raise ValueError(f"unknown strategy {strategy!r}; choose from {STRATEGIES}")

    # Negative c(tau) values (possible for large tau in eq. 15/17) would flip
    # the gradient sign; the paper's clip-to-[0, 5 alpha_c] protocol removes them.
    if clip_factor is not None:
        sched = StepSizeSchedule(np.maximum(sched.table, 0.0), name=sched.name)
        sched = clip_table(sched, alpha_c, clip_factor)
    if tau_drop is not None:
        sched = drop_above(sched, tau_drop)
    if normalize_pmf is not None:
        # Iterate normalize -> clip: each clip lowers E[alpha] below alpha_c,
        # each normalize raises it back; fixpoint is E = min(alpha_c,
        # clip_factor * alpha_c * P[alpha > 0]) (the cap can make exact
        # equality unreachable when most mass sits at dropped taus).
        for _ in range(8):
            sched = normalize_expectation(sched, normalize_pmf, alpha_c)
            if clip_factor is None:
                break
            clipped = clip_table(sched, alpha_c, clip_factor)
            if np.allclose(clipped.table, sched.table, rtol=1e-6, atol=0):
                sched = clipped
                break
            sched = clipped
    return sched
