"""Full-fidelity checkpoint/resume for the Run API (port of
``src/repro/run/ckpt.py``).

A checkpoint must capture *everything* the next step reads, or the resumed
trajectory diverges.  Two halves:

* **Device state** — the whole :class:`~repro_torch.training.steps.TrainState`:
  params (flat-native under ``fuse``), optimizer state (including the fused
  ``{"p", "bufs"}`` layout), the delayed ring (per-leaf or flat ``(K, N)``),
  the ``AdaptState`` tables *and the device histogram*, the step counter and
  the workers' generator.  Saved through :mod:`repro_torch.checkpoint.store`
  (key-path-named npz; restore validates structure against the engine-built
  template).
* **Host state** — the adaptation loop's host half, which lives on the
  pipeline object between steps: the online estimator's float64 histogram +
  sample count, and the staleness link's current schedule table.  Saved as a
  small sidecar npz and restored by *mutating the live pipeline*, leniently
  on shape (a refresh may legitimately resize the host table) but strictly
  on estimator support.

With both halves restored, a resumed run is bit-identical to the
uninterrupted one in both engine modes, fused and unfused — including runs
whose resume point crosses a ``refresh_every`` boundary (the partial device
histogram and the estimator counts both round-trip).  Enforced by
tests/test_torch_resume.py, and on the card at full width by
``chip_smoke.py``.
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import os
from typing import Any

import numpy as np

from repro_torch.checkpoint.store import load_train_state, save_train_state

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "refresh_link_of",
]


def refresh_link_of(pipeline) -> Any | None:
    """The host-adaptation handle of ``pipeline``: its ``scale_by_staleness``
    link, or any object carrying an ``estimator`` itself.  None when the
    pipeline carries no host-side adaptation state.

    This is THE resolution — the refresh boundary
    (:func:`repro_torch.run.engine._refresher_of`) resolves through it too,
    so the object the checkpoint persists is always the object a refresh
    mutates.
    """
    from repro_torch.optim import transform as T

    if pipeline is None:
        return None
    if isinstance(pipeline, T.GradientTransform):
        return T.staleness_link(pipeline)
    return pipeline if hasattr(pipeline, "estimator") else None


def _host_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}_host.npz")


def save_checkpoint(directory: str, state: Any, pipeline: Any, step: int) -> None:
    """Write device state + host adaptation sidecar for ``step``.

    The host sidecar is written FIRST and the ``latest`` pointer (inside
    :func:`save_train_state`) last, so a crash mid-save can never leave
    ``latest`` naming a checkpoint whose sidecar is missing.
    """
    os.makedirs(directory, exist_ok=True)
    link = refresh_link_of(pipeline)
    host: dict[str, np.ndarray] = {}
    if link is not None:
        sched = getattr(link, "schedule", None)
        if sched is not None:
            host["schedule_table"] = np.asarray(sched.table, np.float64)
        est = getattr(link, "estimator", None)
        if est is not None:
            host["est_counts"] = np.asarray(est.counts, np.float64)
            host["est_n_seen"] = np.int64(est.n_seen)
    tmp = _host_path(directory, step) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, _host_path(directory, step))
    save_train_state(directory, state, step)


def restore_checkpoint(
    directory: str, template_state: Any, pipeline: Any, *, step: int | None = None,
    device: Any = None,
) -> tuple[Any, int]:
    """Restore ``(state, step)`` and re-arm the pipeline's host state.

    ``template_state`` is an engine-built state (or shape-only template, with
    its tensors on ``meta``; they are restored onto ``device``) with the
    layout the checkpoint was saved from (same mode, same ``fuse=``);
    structure mismatch raises with the offending key paths.  The pipeline is
    mutated in place: its estimator gets the saved counts/n_seen back, its
    staleness link the saved schedule table — so the next refresh boundary
    refits from exactly the observations the interrupted run had.
    """
    state, step = load_train_state(directory, template_state, step, device=device)
    host_path = _host_path(directory, step)
    link = refresh_link_of(pipeline)
    est = getattr(link, "estimator", None) if link is not None else None
    if not os.path.exists(host_path):
        # device state only: resuming an adaptive run from it would silently
        # restart the estimator — refuse loudly
        if est is not None:
            raise ValueError(
                f"checkpoint {directory!r} step {step} has no host sidecar but the "
                "pipeline carries an online estimator — it was not saved by "
                "save_checkpoint; resume cannot be bit-faithful")
        return state, step
    host = np.load(host_path)
    if link is not None and "schedule_table" in host.files:
        from repro_torch.core.step_size import StepSizeSchedule

        sched = getattr(link, "schedule", None)
        name = sched.name if sched is not None else "restored"
        # lenient on shape by design: a past refresh may have resized the host
        # table; the saved one is the truth the interrupted run was using
        link.schedule = StepSizeSchedule(table=np.asarray(host["schedule_table"]), name=name)
    if est is not None:
        if "est_counts" not in host.files:
            raise ValueError(
                f"checkpoint {directory!r} step {step}: pipeline has an estimator "
                "but the host sidecar saved none — was it saved from a different "
                "pipeline?")
        counts = np.asarray(host["est_counts"], np.float64)
        if counts.shape != est.counts.shape:
            raise ValueError(
                f"estimator support mismatch: checkpoint histogram {counts.shape} "
                f"!= estimator {est.counts.shape} (tau_max changed between save "
                "and resume)")
        est.counts = counts
        est.n_seen = int(host["est_n_seen"])
    return state, step
