"""Online staleness adaptation over the PyTorch/CUDA port (``repro_torch``):
the counterpart of ``examples/online_adaptation.py``.

The estimator observes real tau values, refits the distribution model every
2000 observations and rebuilds the alpha(tau) schedule, tracking a
NON-STATIONARY scheduler (the worker pool doubles mid-run).  Each rebuilt
table is written into an ``AdaptState`` on ``--device`` in place, as the
trainer's refresh does, so the training step would read it there.

    PYTHONPATH=src python examples/online_adaptation_torch.py              # on the card
    PYTHONPATH=src python examples/online_adaptation_torch.py --device cpu

Ends with ``check: fitted lam ...: ok`` (or ``FAILED``, exit code 1): at the
end of each phase the fitted Poisson lam is within 30 % of the worker count.
"""

import argparse
import sys

import numpy as np

from repro_torch.async_engine import EventSimConfig, simulate_staleness_trace
from repro_torch.core.estimator import OnlineStalenessEstimator
from repro_torch.training import make_adapt

PHASE_STEPS = 6000
WORKERS = (8, 16)  # phase 1; phase 2 (e.g. an elastic scale-up)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trace = np.concatenate([
        simulate_staleness_trace(EventSimConfig(m=m, compute_mean=1.0, apply_mean=0.02),
                                 PHASE_STEPS, seed=i)
        for i, m in enumerate(WORKERS)])

    est = OnlineStalenessEstimator(m=WORKERS[0], tau_max=128, decay=0.5)
    adapt = None
    lams = {}
    print(f"{'step':>6} {'E[tau]':>8} {'fitted lam':>11} {'mode':>5}  schedule head")
    for step in range(0, len(trace), 2000):
        est.observe(trace[step:step + 2000])
        if step == PHASE_STEPS:
            est.m = WORKERS[1]  # elastic resize signal reaches the server
        model = est.fit("poisson")
        sched = est.rebuild_schedule("poisson_momentum", alpha_c=0.01)
        fresh = make_adapt(sched, model, cdf_support=64, tau_max=128, device=args.device)
        if adapt is None:
            adapt = fresh
        else:  # the refresh writes into the tensors the step holds
            adapt.alpha_table.copy_(fresh.alpha_table)
            adapt.tau_cdf.copy_(fresh.tau_cdf)
        lams[step + 2000] = model.lam
        head = adapt.alpha_table[:4].cpu().numpy()
        print(f"{step + 2000:>6} {est.mean_tau():>8.2f} {model.lam:>11.2f} "
              f"{model.mode():>5}  {np.round(head, 4)}")

    print("\nThe fitted lambda tracks the worker count through the scale-up —")
    print("the exponential forgetting (decay=0.5, applied once per")
    print("rebuild_schedule refresh boundary; fit() is a pure read) lets the")
    print("histogram adapt.")
    ends = {PHASE_STEPS: WORKERS[0], 2 * PHASE_STEPS: WORKERS[1]}
    ok = all(abs(lams[s] - m) <= 0.3 * m for s, m in ends.items())
    print(f"check: fitted lam {[round(lams[s], 2) for s in ends]} within 30 % of the worker "
          f"counts {list(ends.values())}: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
