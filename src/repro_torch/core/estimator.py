"""Online staleness-distribution estimation (port of ``src/repro/core/estimator.py``).

MindTheStep adapts ``alpha(tau)`` *online*: the parameter server observes each
update's staleness, maintains a histogram, and periodically refits the
distribution model (paper §IV: the mode relation ``lam^{1/nu} = m`` reduces the
CMP fit to a 1-D search; for Poisson, ``lam = m`` directly).

The estimator lives host-side between ticks (updates are O(1) numpy);
its product — a :class:`~repro_torch.core.step_size.StepSizeSchedule` table — is the
device-facing artifact.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import staleness as S
from repro_torch.core import step_size as SS

__all__ = ["OnlineStalenessEstimator"]


@dataclasses.dataclass
class OnlineStalenessEstimator:
    """Streaming histogram + model refitting + schedule rebuilding.

    Parameters
    ----------
    m:          number of workers (drives the mode relation, eq. 13).
    tau_max:    histogram support (the paper drops tau > 150 anyway).
    decay:      exponential forgetting applied once per refresh boundary
                (:meth:`forget`, called by :meth:`rebuild_schedule`) so the
                estimator tracks non-stationary schedulers (beyond-paper,
                documented).  :meth:`fit` is a pure read — calling it twice
                is idempotent.
    """

    m: int
    tau_max: int = 256
    decay: float = 1.0
    counts: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    n_seen: int = 0

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.tau_max + 1, dtype=np.float64)

    def observe(self, tau) -> None:
        taus = np.atleast_1d(np.asarray(tau, dtype=np.int64))
        np.add.at(self.counts, np.clip(taus, 0, self.tau_max), 1.0)
        self.n_seen += taus.size

    def observe_counts(self, counts) -> None:
        """Merge a pre-binned histogram (e.g. the device-resident ``AdaptState.hist``
        drained at a refresh boundary).  Mass beyond ``tau_max`` folds into
        the last bin — the same clip :meth:`observe` applies per sample."""
        c = np.asarray(counts, dtype=np.float64)
        n = min(c.size, self.counts.size)
        self.counts[:n] += c[:n]
        if c.size > n:
            self.counts[-1] += c[n:].sum()
        self.n_seen += int(c.sum())

    def pmf(self) -> np.ndarray:
        total = self.counts.sum()
        if total == 0:
            # uninformed prior: Poisson(m) — the paper's default hypothesis
            # reprolint: disable=RL001 — host-side estimator; m is a python int
            return S.Poisson(float(max(self.m, 1))).pmf_table(self.tau_max)
        return self.counts / total

    def mean_tau(self) -> float:
        p = self.pmf()
        return float(np.sum(np.arange(len(p)) * p))

    def fit(self, family: str = "cmp") -> S.StalenessModel:
        """Refit the chosen family to the current histogram."""
        p = self.pmf()
        if family == "poisson":
            # lam = observed mean; the paper's Table I finds lam ~= m.
            lam = max(self.mean_tau(), 1e-3)
            model: S.StalenessModel = S.Poisson(lam)
        elif family == "cmp":
            model = S.CMP.fit_mode_relation(p, max(self.m, 1), is_pmf=True)
        elif family == "geometric":
            mean = self.mean_tau()
            model = S.Geometric(p=1.0 / (1.0 + mean))
        elif family == "uniform":
            nz = np.nonzero(p > 0)[0]
            model = S.BoundedUniform(int(nz[-1]) if nz.size else 0)
        else:
            raise ValueError(f"unknown family {family!r}")
        return model

    def forget(self) -> None:
        """Apply the exponential forgetting once — the explicit refresh
        boundary.  Kept out of :meth:`fit` so read-path calls stay idempotent
        (fit-twice used to decay the histogram twice)."""
        if self.decay < 1.0:
            self.counts *= self.decay

    def rebuild_schedule(
        self,
        strategy: str,
        alpha_c: float,
        *,
        family: str = "poisson",
        K: float = 1.0,
        mu_star: float = 0.0,
        clip_factor: float | None = 5.0,
        tau_drop: int | None = 150,
        normalize: bool = True,
    ) -> SS.StepSizeSchedule:
        """Fit the model and build the paper-protocol schedule in one call.

        This IS the refresh boundary: exponential forgetting (``decay``) is
        applied exactly once per SUCCESSFUL rebuild, after the histogram has
        been read — a failed rebuild (e.g. the eq.-26 normalization raising)
        must not erode the observations it will need to try again.
        """
        model = self.fit(family)
        pmf = self.pmf() if normalize else None
        sched = SS.make_schedule(
            strategy,
            alpha_c,
            model,
            K=K,
            mu_star=mu_star,
            tau_max=self.tau_max,
            normalize_pmf=pmf,
            clip_factor=clip_factor,
            tau_drop=tau_drop,
        )
        self.forget()
        return sched
