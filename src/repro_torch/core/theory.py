"""Analytic results of the paper as executable calculators.

* Theorem 1  — SyncPSGD effective batch size (scalability of the synchronous
  baseline): ``m`` workers at batch ``b`` ≡ sequential SGD at ``m*b``; the
  gradient-estimator variance shrinks ~``1/(m*b)``.
* Lemma 1    — expected-update decomposition with the stale-gradient series
  ``Sigma_{p,alpha}^grad`` (eq. 6–7); provided as a numeric evaluator so the
  cancellation theorems can be *verified*, not just trusted.
* Theorem 6  — iteration bound for eps-convergence under strongly-convex +
  Lipschitz + bounded-second-moment assumptions (eq. 22).
* Corollary 3 — optimal constant step (eq. 23) and the O(E[tau]) bound (eq. 24).
* Corollary 4 — bound for any non-increasing alpha(tau) (eq. 25).

Port of ``src/repro/core/theory.py``: the same numpy float64 code over the
port's own :mod:`repro_torch.core.staleness` and :mod:`repro_torch.core.step_size`,
so both packages give the same bounds.
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.staleness import StalenessModel
from repro_torch.core.step_size import StepSizeSchedule

__all__ = [
    "effective_batch_size",
    "max_useful_workers",
    "gradient_variance_scaling",
    "sigma_series",
    "ConvexProblem",
    "theorem6_improvement_factor",
    "theorem6_bound",
    "corollary3_alpha",
    "corollary3_bound",
    "corollary4_bound",
]


# ---------------------------------------------------------------------------
# Theorem 1 — SyncPSGD scalability
# ---------------------------------------------------------------------------

def effective_batch_size(m: int, b: int) -> int:
    """Thm 1: averaging ``m`` workers with batch ``b`` == one step at ``m*b``."""
    return m * b


def max_useful_workers(b_star: int) -> int:
    """With an optimal batch ``b*`` and the hard floor ``b >= 1``, at most
    ``m = b*`` workers can contribute to optimal convergence (paper §III)."""
    return b_star


def gradient_variance_scaling(b: int, sigma2_single: float) -> float:
    """Variance of a size-``b`` mini-batch gradient estimator (i.i.d. samples,
    sampling without replacement approximated as with-replacement)."""
    return sigma2_single / b


# ---------------------------------------------------------------------------
# Lemma 1 — the stale-gradient series (numeric evaluator)
# ---------------------------------------------------------------------------

def sigma_series(
    pmf: np.ndarray,
    alpha_table: np.ndarray,
    grads: np.ndarray,
) -> np.ndarray:
    """Evaluate ``Sigma_{p,alpha}^grad = sum_i (p(i)a(i) - p(i+1)a(i+1)) g[i]``
    (eq. 7), where ``g[i]`` stands for ``grad f(x_{t-i-1})``.

    ``grads`` has shape ``(n, d)``; the series is truncated at
    ``n = min(len(pmf), len(alpha_table)) - 1`` terms.
    """
    n = min(len(pmf), len(alpha_table)) - 1
    pa = np.asarray(pmf[: n + 1], dtype=np.float64) * np.asarray(
        alpha_table[: n + 1], dtype=np.float64
    )
    w = pa[:-1] - pa[1:]  # (n,)
    g = np.asarray(grads[:n], dtype=np.float64)
    return (w[:, None] * g).sum(axis=0)


# ---------------------------------------------------------------------------
# Theorem 6 and corollaries — convex convergence bounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvexProblem:
    """Constants of Assumption 1 plus the start distance.

    c  — strong convexity (eq. 19)
    L  — Lipschitz constant of the stochastic gradient (eq. 20)
    M  — second-moment bound: E[||grad F||^2] <= M^2 (eq. 21)
    r0 — ||x_0 - x*||^2
    """

    c: float
    L: float
    M: float
    r0: float


def theorem6_improvement_factor(
    prob: ConvexProblem,
    eps: float,
    e_alpha: float,
    e_alpha2: float,
    e_tau_alpha: float,
) -> float:
    """Per-step contraction ``delta`` from the proof of Thm 6:

    ``delta = 2 (c - L M eps^{-1/2} E[tau alpha]) E[alpha] - eps^{-1} M^2 E[alpha^2]``.

    Convergence requires ``delta > 0``; then ``E||x_t - x*||^2`` contracts by
    ``(1 - delta)`` per step while above ``eps``.
    """
    return (
        2.0 * (prob.c - prob.L * prob.M * e_tau_alpha / math.sqrt(eps)) * e_alpha
        - prob.M**2 * e_alpha2 / eps
    )


def theorem6_bound(
    prob: ConvexProblem,
    eps: float,
    schedule: StepSizeSchedule,
    model: StalenessModel,
    tau_max: int | None = None,
) -> float:
    """Eq. (22): iterations sufficient for ``E||x_T - x*||^2 < eps``.

    Returns ``inf`` when the step size violates the convergence condition
    (``delta <= 0``).
    """
    n = tau_max if tau_max is not None else schedule.tau_max
    pmf = model.pmf_table(n)
    e_a = schedule.expectation(pmf)
    e_a2 = schedule.second_moment(pmf)
    e_ta = schedule.tau_alpha_expectation(pmf)
    delta = theorem6_improvement_factor(prob, eps, e_a, e_a2, e_ta)
    if delta <= 0.0 or delta >= 1.0:
        return math.inf if delta <= 0.0 else math.log(prob.r0 / eps)  # contraction floor
    return math.log(prob.r0 / eps) / delta


def corollary3_alpha(prob: ConvexProblem, eps: float, tau_bar: float, theta: float = 1.0) -> float:
    """Eq. (23): ``alpha = theta * c eps M^{-1} / (M + 2 L sqrt(eps) tau_bar)``,
    ``theta in (0, 2)``; ``theta = 1`` maximizes the contraction."""
    if not 0.0 < theta < 2.0:
        raise ValueError("theta must be in (0, 2)")
    rho = prob.c * eps / (prob.M * (prob.M + 2.0 * prob.L * math.sqrt(eps) * tau_bar))
    return theta * rho


def corollary3_bound(prob: ConvexProblem, eps: float, tau_bar: float, theta: float = 1.0) -> float:
    """Eq. (24): ``T <= (M + 2 L sqrt(eps) tau_bar) / (theta (2-theta) c^2 M^{-1} eps)
    * ln(r0 / eps)`` — O(E[tau]), improving prior O(max tau) bounds."""
    if not 0.0 < theta < 2.0:
        raise ValueError("theta must be in (0, 2)")
    num = prob.M + 2.0 * prob.L * math.sqrt(eps) * tau_bar
    den = theta * (2.0 - theta) * prob.c**2 * eps / prob.M
    return (num / den) * math.log(prob.r0 / eps)


def corollary4_bound(
    prob: ConvexProblem,
    eps: float,
    schedule: StepSizeSchedule,
    model: StalenessModel,
    tau_max: int | None = None,
) -> float:
    """Eq. (25): for any *non-increasing* ``alpha(tau)``:

    ``T <= [2 c E[alpha] - eps^{-1} M (M + 2 L sqrt(eps) tau_bar) E[alpha^2]]^{-1}
    ln(r0/eps)``.
    """
    n = tau_max if tau_max is not None else schedule.tau_max
    tab = schedule.table[: n + 1]
    if np.any(np.diff(tab) > 1e-12):
        raise ValueError("Corollary 4 requires a non-increasing alpha(tau)")
    pmf = model.pmf_table(n)
    e_a = schedule.expectation(pmf)
    e_a2 = schedule.second_moment(pmf)
    tau_bar = float(np.sum(np.arange(n + 1) * (pmf / pmf.sum())))
    delta = 2.0 * prob.c * e_a - (prob.M * (prob.M + 2.0 * prob.L * math.sqrt(eps) * tau_bar) * e_a2) / eps
    if delta <= 0.0:
        return math.inf
    return math.log(prob.r0 / eps) / delta
