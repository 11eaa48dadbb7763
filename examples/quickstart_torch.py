"""Quickstart over the PyTorch/CUDA port (``repro_torch``): the counterpart
of ``examples/quickstart.py``.

1. Fit a staleness model to a simulated async execution (paper §IV).
2. Build the staleness-adaptive step-size schedule (eq. 17 protocol).
3. Train a small LM with the async MindTheStep step: the update is one
   composable pipeline (``chain(scale_by_staleness(...), scale(-lr))``), the
   run one declarative ``RunSpec`` executed by ``run(spec, hooks)``, the
   alpha table / tau CDF / staleness histogram held on the device in
   ``TrainState.adapt`` and refreshed online every 20 steps.  ``--fuse``
   makes each tick one ``fused_tick`` kernel launch on the card.

    PYTHONPATH=src python examples/quickstart_torch.py             # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Ends with ``check: loss fell ...: ok`` (or ``FAILED``, exit code 1).
"""

import argparse
import sys

import numpy as np

from repro_torch.async_engine import EventSimConfig, simulate_staleness_trace
from repro_torch.configs import get_config, reduced
from repro_torch.core import staleness as S
from repro_torch.core import step_size as SS
from repro_torch.optim import transform as T
from repro_torch.run import LogHook, RunSpec, run
from repro_torch.training import make_adapt

M_WORKERS = 8
ALPHA_C = 0.05


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--fuse", action="store_true", help="one fused_tick launch per tick")
    args = ap.parse_args(argv)

    # -- 1. observe staleness + fit the paper's models ---------------------------
    taus = simulate_staleness_trace(
        EventSimConfig(m=M_WORKERS, compute_mean=1.0, apply_mean=0.02), 10_000, seed=0)
    fits = S.fit_all_models(taus, m=M_WORKERS)
    print("tau-model fits (Bhattacharyya distance to observed):")
    for name, (model, dist) in sorted(fits.items(), key=lambda kv: kv[1][1]):
        print(f"  {name:<16} D = {dist:.4f}   {model}")
    poisson = fits["Poisson"][0]

    # -- 2. the MindTheStep schedule (eq. 17: Poisson model, K=1, normalized) ----
    pmf = S.empirical_pmf(taus, tau_max=63)
    sched = SS.make_schedule("poisson_momentum", ALPHA_C, poisson, K=1.0, tau_max=63,
                             normalize_pmf=pmf)
    print(f"\nalpha(tau) table head: {np.round(sched.table[:6], 4)}")
    print(f"E_tau[alpha(tau)] = {sched.expectation(pmf):.4f} (alpha_c = {ALPHA_C})")

    # -- 3. async training with delayed gradients + adaptive steps ---------------
    cfg = reduced(get_config("stablelm-1.6b"), d_model=128)
    pipeline = T.chain(
        T.scale_by_staleness(sched, ALPHA_C, m=M_WORKERS, tau_max=63),
        T.scale(-ALPHA_C),
    )
    spec = RunSpec(
        cfg=cfg, pipeline=pipeline, mode="async", num_steps=args.steps,
        batch_size=8, seq_len=64, num_workers=M_WORKERS, ring=32,
        adapt=make_adapt(sched, poisson, cdf_support=32, tau_max=63),
        refresh_every=20, seed=0, fuse=args.fuse, device=args.device,
    )
    result = run(spec, hooks=[LogHook(log_every=20)])
    est = T.staleness_link(pipeline).estimator
    first, last = result.history[0]["loss"], result.history[-1]["loss"]
    print(f"\ndone — final loss {last:.3f} (started {first:.3f}); "
          f"online lam estimate {est.fit('poisson').lam:.2f}")
    ok = last < first
    print(f"check: loss fell from {first:.3f} to {last:.3f}: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
