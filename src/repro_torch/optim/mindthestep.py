"""MindTheStep, the paper's staleness-adaptive step, as the legacy optimizer
wrapper (port of ``src/repro/optim/mindthestep.py``).

DEPRECATED shim: the wrapper is the chain

    chain(scale_by_staleness(schedule, alpha_c), *base_optimizer_links)

and :class:`MindTheStep` keeps the legacy interface on top of it; its
trajectory is bitwise that of the chain run directly
(``tests/test_torch_optim_shims.py``).  New code builds the chain:

    from repro_torch.optim import transform as T
    pipe = T.chain(T.scale_by_staleness(schedule, alpha_c, m=m),
                   T.scale(-lr), T.trace(mu))

Algorithm 1 of the paper: the parameter server applies each gradient with a
staleness-adaptive step ``x <- x - alpha(tau) g``:

    mts = mindthestep(base_optimizer, schedule, alpha_c)
    new_params, state = mts.update(grads, state, params, tau=tau)

``schedule`` is a :class:`repro_torch.core.step_size.StepSizeSchedule`.  The
base optimizer sees the ``alpha(tau) / alpha_c``-scaled gradient and knows
nothing of asynchrony.  ``observe(tau)`` / ``observe_counts(hist)`` feed the
online estimator and ``refresh()`` refits the staleness model and rebuilds
the table (forgetting applied once per refresh).
"""

from __future__ import annotations

from repro_torch.core.estimator import OnlineStalenessEstimator
from repro_torch.core.step_size import StepSizeSchedule
from repro_torch.optim import transform as T
from repro_torch.optim.base import Optimizer

__all__ = ["MindTheStep", "mindthestep"]


class MindTheStep:
    """Staleness-adaptive wrapper around a base :class:`Optimizer`.

    ``self.link`` is the ``scale_by_staleness`` link and ``self.pipeline``
    the whole chain; ``schedule`` / ``alpha_c`` / ``estimator`` read through
    to the link, so a refresh through either handle stays coherent.
    """

    def __init__(self, base: Optimizer, schedule: StepSizeSchedule, alpha_c: float,
                 estimator: OnlineStalenessEstimator | None = None):
        self.base = base
        self.link = T.scale_by_staleness(schedule, alpha_c)
        self.link.estimator = estimator
        base_links = getattr(base.pipeline, "links", ())
        self.pipeline = T.chain(self.link, *base_links) if base_links else None

    @property
    def schedule(self) -> StepSizeSchedule:
        return self.link.schedule

    @schedule.setter
    def schedule(self, sched) -> None:
        self.link.schedule = sched

    @property
    def alpha_c(self) -> float:
        return self.link.alpha_c

    @property
    def estimator(self) -> OnlineStalenessEstimator | None:
        return self.link.estimator

    def init(self, params):
        return self.base.init(params)

    def update(self, grads, state, params, tau=0, scale=1.0):
        """Apply ``grads`` with step ``alpha(tau)`` (times ``scale``): the
        staleness link scales the raw gradient, then the base shim runs the
        remaining links with the legacy state."""
        u, _ = self.link.update(grads, (), params, T.StepContext(tau=tau))
        return self.base.update(u, state, params, scale=scale)

    def table(self):
        return self.schedule.device_table

    def observe(self, tau) -> None:
        self.link.observe(tau)

    def observe_counts(self, counts) -> None:
        """Merge a pre-binned histogram (a drained ``AdaptState.hist``)."""
        self.link.observe_counts(counts)

    def refresh(self, strategy: str = "poisson_momentum", *, family: str = "poisson",
                K: float | None = None, normalize: bool = True) -> None:
        """Refit the staleness model and rebuild alpha(tau); ``K`` defaults
        to ``alpha_c``."""
        self.link.refresh(strategy, family=family, K=K, normalize=normalize)


def mindthestep(base: Optimizer, schedule: StepSizeSchedule, alpha_c: float, *,
                m: int | None = None, tau_max: int = 256) -> MindTheStep:
    """Build the wrapper; ``m`` attaches an online estimator (paper §IV)."""
    est = OnlineStalenessEstimator(m=m, tau_max=tau_max) if m is not None else None
    return MindTheStep(base=base, schedule=schedule, alpha_c=alpha_c, estimator=est)
