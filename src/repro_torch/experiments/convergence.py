"""Paper Fig. 3: iterations-to-threshold, AsyncPSGD vs MindTheStep-AsyncPSGD
(the counterpart of ``benchmarks/convergence.py``).

    PYTHONPATH=src python -m repro_torch.experiments.convergence [--fast] [--device cpu]

Protocol (§VI) on the exact shared-memory simulator
(:func:`repro_torch.async_engine.simulate_async_sgd`):

* commit orders from the event-driven timing model with heterogeneous worker
  speeds (heavy-tailed tau);
* baseline: constant alpha_c.  MindTheStep: the Thm-3/Cor-1 geometric
  schedule with mu* = 0 fitted to the OBSERVED tau pmf, normalized per
  eq. (26), clipped at 5 alpha_c, tau > 150 dropped;
* also the Thm-5 CMP schedule (K = 1, clip factor 1.0) and the
  staleness-decay baselines AdaDelay and inverse-tau.

Classifier: the 2-layer MLP on Gaussian blobs; alpha_c = 0.3.
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import argparse
import time
from typing import Any, Callable

import numpy as np

from repro_torch.async_engine import simulate_async_sgd
from repro_torch.core import staleness as S
from repro_torch.core import step_size as SS
from repro_torch.experiments.common import event_order, iters_to, mlp_problem
from repro_torch.models.cnn import mlp_loss

WORKER_COUNTS = (8, 16, 24, 32)
NAMES = ("const", "mindthestep_geom", "mindthestep_cmp", "adadelay", "inverse_tau")


def run(T: int = 4000, bsz: int = 16, alpha_c: float = 0.3, thresh: float = 0.35,
        repeats: int = 3, workers=WORKER_COUNTS, *, device="cuda",
        params: Callable[[int], Any] | None = None) -> dict:
    """One row per worker count: mean and std of iterations-to-threshold per
    strategy over ``repeats`` event orders.  ``params(rep)`` gives repeat
    ``rep``'s initial MLP params (default: torch's draws).  Each row also
    keeps ``losses``, the loss series of every run, by strategy."""
    rows = []
    for m in workers:
        per_strategy: dict[str, list[int]] = {}
        losses: dict[str, list[np.ndarray]] = {}
        for rep in range(repeats):
            _, order = event_order(m, T, seed=10 + rep)
            p0, batches = mlp_problem(T, bsz, seed=rep, device=device, params=params)

            const = SS.constant(alpha_c, tau_max=255)
            tr_c = simulate_async_sgd(mlp_loss, p0, batches, order, const.table, m=m)
            pmf = S.empirical_pmf(tr_c.taus.cpu().numpy(), tau_max=255)
            geo = S.Geometric(p=max(float(pmf[0]), 1e-3))
            cmp_m = S.CMP.fit_mode_relation(pmf, m, is_pmf=True)
            strategies = {
                "mindthestep_geom": SS.make_schedule(
                    "geometric_momentum", alpha_c, geo, mu_star=0.0, tau_max=255,
                    normalize_pmf=pmf),
                "mindthestep_cmp": SS.make_schedule(
                    "cmp_momentum", alpha_c, cmp_m, K=1.0, tau_max=255,
                    normalize_pmf=pmf, clip_factor=1.0),
                "adadelay": SS.make_schedule("adadelay", alpha_c, tau_max=255,
                                             normalize_pmf=pmf),
                "inverse_tau": SS.make_schedule("inverse_tau", alpha_c, tau_max=255,
                                                normalize_pmf=pmf),
            }
            runs = {"const": tr_c}
            for name, sched in strategies.items():
                runs[name] = simulate_async_sgd(mlp_loss, p0, batches, order, sched.table, m=m)
            for name, tr in runs.items():
                series = tr.losses.cpu().numpy()
                losses.setdefault(name, []).append(series)
                per_strategy.setdefault(name, []).append(iters_to(series, thresh))
        row: dict = {"m": m}
        for name, vals in per_strategy.items():
            row[name] = float(np.mean(vals))
            row[name + "_std"] = float(np.std(vals))
        row["speedup_geom"] = row["const"] / max(row["mindthestep_geom"], 1.0)
        row["losses"] = losses
        rows.append(row)
    return {"rows": rows, "T": T, "thresh": thresh, "alpha_c": alpha_c}


def print_table(out: dict, logger=print) -> None:
    logger(f"== Fig 3: iterations to loss < {out['thresh']} "
           f"(alpha_c={out['alpha_c']}, exact async simulator, "
           f"heterogeneous event-driven commit order) ==")
    logger(f"{'m':>4} " + "".join(f"{n:>18}" for n in NAMES) + f"{'geom speedup':>14}")
    for r in out["rows"]:
        cells = "".join(f"{r[n]:>12.0f}±{r[n + '_std']:<5.0f}" for n in NAMES)
        logger(f"{r['m']:>4} {cells}{r['speedup_geom']:>13.2f}x")
    logger("\n(>T+1 means the threshold was never reached; the cmp variant uses clip=1.0)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fast", action="store_true", help="T 2500, one repeat, m in 8, 16, 32")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(T=2500 if args.fast else 4000, repeats=1 if args.fast else 3,
              workers=(8, 16, 32) if args.fast else WORKER_COUNTS, device=args.device)
    out["seconds"] = time.perf_counter() - t0
    print_table(out)
    print(f"({out['seconds']:.1f} s on {args.device})")
    return out


if __name__ == "__main__":
    main()
