"""Device-resident adaptation state for online MindTheStep (paper §IV); port
of ``src/repro/training/adapt.py`` (single-server state only).

:class:`AdaptState` rides in ``TrainState``:

* ``alpha_table`` — f32 ``alpha(tau)`` lookup, gathered on the device per worker;
* ``tau_cdf``     — inverse-CDF table of the staleness model the simulated
  workers draw from (``W`` taus per tick);
* ``hist``        — int32 staleness histogram, scatter-added on the device.

The host syncs only at ``refresh_every`` boundaries: :func:`host_refresh`
copies the histogram to the host (the only device->host transfer of the
adaptation loop), refits, and writes the fresh table into the SAME tensors
with ``copy_`` — the port's form of the reference's "no retrace" guarantee:
a tick that holds these tensors (a CUDA graph, say) sees the new tables.

:func:`sample_taus` takes uniforms, not a key: the step draws them from a
``torch.Generator`` on the device, and a test can inject the reference's own
draws, so both packages sample the same taus.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.async_engine.delayed import staleness_cdf

__all__ = [
    "AdaptState",
    "init_adapt",
    "make_adapt",
    "default_adapt_setup",
    "sample_taus",
    "alpha_lookup",
    "record_taus",
    "host_refresh",
]


@dataclasses.dataclass
class AdaptState:
    """Adaptation tables + telemetry; shapes are fixed across refreshes."""

    alpha_table: torch.Tensor  # (tau_max + 1,) f32 — alpha(tau)
    tau_cdf: torch.Tensor  # (S,) f32 — inverse-CDF sampling table
    hist: torch.Tensor  # (tau_max + 1,) int32 — observed-tau histogram

    @property
    def tau_max(self) -> int:
        return self.alpha_table.shape[0] - 1

    def to(self, device) -> "AdaptState":
        return AdaptState(*(t.to(device) for t in (self.alpha_table, self.tau_cdf, self.hist)))

    def clone(self) -> "AdaptState":
        return AdaptState(*(t.clone() for t in (self.alpha_table, self.tau_cdf, self.hist)))


def init_adapt(alpha_table, tau_cdf, *, device="cpu") -> AdaptState:
    """Build an AdaptState from raw tables (histogram starts empty)."""
    at = torch.as_tensor(alpha_table, dtype=torch.float32).to(device)
    return AdaptState(
        alpha_table=at,
        tau_cdf=torch.as_tensor(tau_cdf, dtype=torch.float32).to(device),
        hist=torch.zeros(at.shape, dtype=torch.int32, device=device),
    )


def make_adapt(schedule, model, *, cdf_support: int, tau_max: int | None = None,
               device="cpu") -> AdaptState:
    """AdaptState from a schedule + staleness model; taus are drawn from
    ``[0, cdf_support)`` (set it to the ring depth)."""
    table = np.asarray(schedule.table, np.float64)
    if tau_max is not None:
        assert len(table) >= tau_max + 1, "schedule table shorter than tau_max"
        table = table[: tau_max + 1]
    return init_adapt(table, staleness_cdf(model.pmf_table(cdf_support - 1)), device=device)


def default_adapt_setup(alpha_c: float, workers: int, ring: int, *,
                        tau_max: int | None = None, device="cpu"):
    """The production async recipe (same as the reference): Poisson(workers)
    staleness, the eq.-17 schedule with K = alpha_c normalized per eq. 26
    against the ring-truncated pmf, and an AdaptState whose CDF covers the
    ring.  Returns ``(schedule, model, adapt)``."""
    from repro_torch.core.staleness import Poisson
    from repro_torch.core.step_size import make_schedule

    tau_max = ring * 4 if tau_max is None else tau_max
    model = Poisson(float(workers))
    pmf = model.pmf_table(ring - 1)
    sched = make_schedule(
        "poisson_momentum", alpha_c, model, K=alpha_c,
        tau_max=tau_max, normalize_pmf=pmf / np.sum(pmf),
    )
    return sched, model, make_adapt(sched, model, cdf_support=ring, tau_max=tau_max, device=device)


# ---------------------------------------------------------------------------
# Device-side primitives (no host sync)
# ---------------------------------------------------------------------------

def sample_taus(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: one tau per uniform in ``u`` — (W,) int32.  Same
    left-side search as the reference's ``jnp.searchsorted``."""
    return torch.searchsorted(cdf, u.to(cdf.dtype), out_int32=True)


def alpha_lookup(adapt: AdaptState, taus: torch.Tensor) -> torch.Tensor:
    """Gather ``alpha(tau)`` for a vector of taus."""
    return adapt.alpha_table[taus.long().clamp(0, adapt.tau_max)]


def record_taus(adapt: AdaptState, taus: torch.Tensor) -> AdaptState:
    """Scatter-add observed taus into the histogram, in place (clipped to its
    support, the same clip the host estimator's ``observe()`` applies)."""
    idx = taus.long().clamp(0, adapt.tau_max)
    adapt.hist.index_add_(0, idx, torch.ones_like(idx, dtype=adapt.hist.dtype))
    return adapt


# ---------------------------------------------------------------------------
# Host-side refresh boundary
# ---------------------------------------------------------------------------

def host_refresh(
    adapt: AdaptState,
    mts: Any,
    *,
    strategy: str = "poisson_momentum",
    family: str = "poisson",
    K: float | None = None,
    normalize: bool = True,
    refresh_cdf: bool = False,
    logger: Any = print,
) -> AdaptState:
    """Drain the histogram, refit, and write the fresh tables in place.

    Same policy as the reference: only ``alpha_table`` is rebuilt unless
    ``refresh_cdf`` (the sampler models the environment, not our estimate of
    it).  Returns ``adapt`` itself — its tensors now hold the new tables and
    an empty histogram.
    """
    assert mts.estimator is not None, "host_refresh needs a scale_by_staleness link with an estimator"
    # The refresh boundary is the one deliberate device->host sync of the
    # adaptation loop (every refresh_every ticks, not per tick).
    counts = adapt.hist.cpu().numpy()
    if refresh_cdf:
        mts.estimator.observe_counts(counts)
        counts = None
        model = mts.estimator.fit(family)
        adapt.tau_cdf.copy_(staleness_cdf(model.pmf_table(adapt.tau_cdf.shape[0] - 1)))
    table = _refit_alpha_table(
        counts, mts, strategy=strategy, family=family, K=K,
        normalize=normalize, logger=logger, n_bins=adapt.alpha_table.shape[0],
    )
    adapt.alpha_table.copy_(table)
    adapt.hist.zero_()
    return adapt


def _refit_alpha_table(
    counts: np.ndarray | None,
    mts: Any,
    *,
    strategy: str,
    family: str,
    K: float | None,
    normalize: bool,
    logger: Any,
    n_bins: int,
) -> torch.Tensor:
    """Observe drained ``counts``, refit/rebuild the schedule, return the new
    f32 table (CPU) truncated to ``n_bins``; keeps the previous schedule when
    the data-dependent eq.-26 normalization fails, as the reference does."""
    from repro_torch.core.step_size import STRATEGIES

    assert strategy in STRATEGIES, f"unknown strategy {strategy!r}; choose from {STRATEGIES}"
    assert family in ("poisson", "cmp", "geometric", "uniform"), f"unknown family {family!r}"
    if K is None:
        K = mts.alpha_c
    if counts is not None:
        mts.estimator.observe_counts(counts)
    try:
        mts.refresh(strategy, family=family, K=K, normalize=normalize)
    except ValueError as e:
        if logger is not None:
            logger(
                f"host_refresh: kept previous schedule "
                f"(n_seen={mts.estimator.n_seen}): {e}"
            )
    table = np.asarray(mts.schedule.table, np.float64)
    assert len(table) >= n_bins, (
        f"refreshed schedule support {len(table) - 1} < adapt tau_max {n_bins - 1}; "
        "construct the estimator with tau_max >= adapt.tau_max"
    )
    return torch.from_numpy(table[:n_bins].astype(np.float32))
