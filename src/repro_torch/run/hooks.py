"""Hook lifecycle (port of ``src/repro/run/hooks.py``; only the log hook so far).

``on_start`` once, ``on_tick`` after every tick, ``on_refresh`` after each
refresh boundary, ``on_end`` once.  Hooks read ``ctx`` and never mutate the
training state.
"""

from __future__ import annotations

import time
from typing import Callable

__all__ = ["Hook", "LogHook"]


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
