"""Hook lifecycle protocol + the built-in hooks (port of
``src/repro/run/hooks.py``).

``on_start`` once (after a resume restore), ``on_tick`` after every tick,
``on_refresh`` after each refresh boundary, ``on_end`` once.  Hooks read
``ctx`` and never mutate the training state.  Built-ins:

* :class:`LogHook`        — console lines + history rows.
* :class:`BenchHook`      — bench.v1 rows (loss series, wall-clock).
* :class:`EvalHook`       — periodic evaluation callback.
* :class:`CheckpointHook` — full-fidelity save via :mod:`repro_torch.run.ckpt`
  (device state + host estimator sidecar) at a fixed cadence.
"""

from __future__ import annotations

import time
from typing import Any, Callable

__all__ = ["Hook", "LogHook", "BenchHook", "EvalHook", "CheckpointHook"]


class Hook:
    def on_start(self, ctx) -> None:
        pass

    def on_tick(self, ctx) -> None:
        pass

    def on_refresh(self, ctx) -> None:
        pass

    def on_end(self, ctx) -> None:
        pass


class LogHook(Hook):
    """Console lines + history rows every ``log_every`` ticks (and the last).

    Converting the metrics to host floats waits for the device, so it only
    happens on the ticks it logs.
    """

    def __init__(self, log_every: int = 50, logger: Callable[[str], None] = print):
        self.log_every = max(int(log_every), 1)
        self.logger = logger
        self._t0 = 0.0

    def on_start(self, ctx) -> None:
        self._t0 = time.perf_counter()

    def on_tick(self, ctx) -> None:
        if ctx.step % self.log_every == 0 or ctx.is_last:
            host = {k: v.item() for k, v in ctx.metrics.items()}
            host["step"] = ctx.step
            host["wall_s"] = time.perf_counter() - self._t0
            ctx.history.append(host)
            self.logger(
                f"step {ctx.step:6d}  loss {host.get('loss', float('nan')):.4f}  "
                f"({host['wall_s']:.1f}s)"
            )


class BenchHook(Hook):
    """Emit bench.v1 rows for one run: final loss with the full
    loss-vs-updates series, and wall-clock.

    ``name`` prefixes the row names (``{name}/final_loss``, ``{name}/wall_s``);
    ``config`` is the cell configuration dict whose hash keys baseline
    comparison.  The reference adds a gated ``{name}/retraces`` row where
    its engine can count jit traces; the port's engines run eagerly
    (``retraces`` is None), so the row is left out, as the reference leaves
    it out for a precompiled engine.  Rows are in ``hook.rows`` after the run
    (and in ``ctx.records[name]``).  The per-tick loss read waits for the
    device each tick, as the reference's does.
    """

    def __init__(self, name: str, config: dict | str):
        self.name = str(name)
        self.config = config
        self.rows: list[dict] = []
        self._losses: list[float] = []
        self._t0 = 0.0
        self._wall_s = 0.0

    def on_start(self, ctx) -> None:
        self._t0 = time.perf_counter()

    def on_tick(self, ctx) -> None:
        self._losses.append(float(ctx.metrics["loss"]))
        self._wall_s = time.perf_counter() - self._t0

    def on_end(self, ctx) -> None:
        from repro_torch.bench_schema import bench_row

        metrics = ctx.metrics or {}
        extras = {k: float(metrics[k]) for k in ("tau_mean", "live_frac") if k in metrics}
        self.rows = [
            bench_row(
                f"{self.name}/final_loss",
                self._losses[-1] if self._losses else float("nan"),
                "nll",
                self.config,
                losses=self._losses,
                updates=list(range(1, len(self._losses) + 1)),
                **extras,
            ),
            bench_row(f"{self.name}/wall_s", self._wall_s, "s", self.config),
        ]
        retraces = getattr(ctx.engine, "retraces", None)
        if retraces is not None:
            self.rows.append(bench_row(f"{self.name}/retraces", retraces, "count",
                                       self.config, gate="lower", tol=0.0))
        ctx.records[self.name] = self.rows


class EvalHook(Hook):
    """Run ``eval_fn(state) -> dict`` every ``every`` steps (and at the end).

    Records land in ``hook.records`` (and ``ctx.records[prefix]``), NOT in
    ``ctx.history``, so history rows keep the training-metrics shape.
    """

    def __init__(self, eval_fn: Callable[[Any], dict], every: int, *, prefix: str = "eval",
                 logger: Callable[[str], None] | None = None):
        self.eval_fn = eval_fn
        self.every = max(int(every), 1)
        self.prefix = prefix
        self.logger = logger
        self.records: list[dict] = []

    def on_tick(self, ctx) -> None:
        if ctx.step % self.every != 0 and not ctx.is_last:
            return
        row = {"step": ctx.step}
        row.update({f"{self.prefix}/{k}": float(v) for k, v in self.eval_fn(ctx.state).items()})
        self.records.append(row)
        ctx.records[self.prefix] = self.records
        if self.logger is not None:
            body = "  ".join(f"{k} {v:.4f}" for k, v in row.items() if k != "step")
            self.logger(f"eval @ step {ctx.step}: {body}")


class CheckpointHook(Hook):
    """Full-fidelity checkpoint every ``every`` steps (see repro_torch.run.ckpt).

    Saves the whole TrainState plus the pipeline's host adaptation state
    (estimator counts, schedule table), so ``run(spec, resume_from=directory)``
    continues bit-identically.  ``at_end=True`` also saves after the final
    step (skipped when the cadence already did).  In a multi-process run
    every rank runs the hook, and the ranks save one checkpoint together,
    in the one-process layout (``engine.checkpoint_layout()``).
    """

    def __init__(self, directory: str, every: int = 0, *, at_end: bool = False):
        self.directory = str(directory)
        self.every = int(every)
        self.at_end = bool(at_end)
        self.saved_steps: list[int] = []
        self._layout = None

    def on_start(self, ctx) -> None:
        # before the first tick, not at the first save: a run whose state
        # cannot be checkpointed raises here
        self._layout = ctx.engine.checkpoint_layout()

    def _save(self, ctx) -> None:
        from repro_torch.run.ckpt import save_checkpoint

        save_checkpoint(self.directory, ctx.state, ctx.engine.pipeline, ctx.step,
                        layout=self._layout)
        self.saved_steps.append(ctx.step)

    def on_tick(self, ctx) -> None:
        if self.every and ctx.step % self.every == 0:
            self._save(ctx)

    def on_end(self, ctx) -> None:
        if self.at_end and ctx.step and ctx.step not in self.saved_steps:
            self._save(ctx)
