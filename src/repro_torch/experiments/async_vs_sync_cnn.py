"""End-to-end run (paper §VI protocol): train the Fig-1 CNN classifier
with (a) constant-alpha AsyncPSGD and (b) MindTheStep on the exact
shared-memory async simulator with m workers, and report
iterations-to-threshold — the Fig. 3 experiment at small scale (the
counterpart of ``examples/async_vs_sync_cnn.py``).

    PYTHONPATH=src python -m repro_torch.experiments.async_vs_sync_cnn [--steps 600] [--m 16]
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from repro_torch.async_engine import simulate_async_sgd
from repro_torch.core import staleness as S
from repro_torch.core import step_size as SS
from repro_torch.data import cifar_like_batches
from repro_torch.experiments.common import event_order, iters_to, to_device
from repro_torch.models.cnn import cnn_loss, init_cnn


def cnn_batches(steps: int, batch: int, image: int, device) -> dict:
    """One minibatch per commit, stacked: ``images (T, b, H, W, 3)``,
    ``labels (T, b)`` (the reference's stream, seed 0), moved to ``device``
    in one copy each."""
    it = cifar_like_batches(batch, image=image, seed=0)
    bs = [next(it) for _ in range(steps)]
    return {k: torch.stack([b[k] for b in bs]).to(device) for k in ("images", "labels")}


def run(steps: int = 600, m: int = 16, batch: int = 16, alpha: float = 0.04, image: int = 16,
        thresh: float = 0.6, *, device="cuda", params: Any = None) -> dict:
    """Both runs on one commit order; ``params`` are the CNN's initial
    params (default: torch's draws from seed 0)."""
    batches = cnn_batches(steps, batch, image, device)
    if params is not None:
        p0 = to_device(params, device)
    else:
        p0 = init_cnn(torch.Generator(device=device).manual_seed(0), image=image, device=device)
    # a realistic heterogeneous-speed commit order (heavy-tailed tau)
    _, order = event_order(m, steps, seed=1)

    def timed(table):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = simulate_async_sgd(cnn_loss, p0, batches, order, table, m=m)
        losses = tr.losses.cpu().numpy()  # waits for the device
        return tr, losses, time.perf_counter() - t0

    # (a) constant-alpha AsyncPSGD baseline
    tr_c, losses_c, s_c = timed(SS.constant(alpha, tau_max=255).table)
    # (b) MindTheStep: fit the observed tau distribution, build alpha(tau)
    pmf = S.empirical_pmf(tr_c.taus.cpu().numpy(), tau_max=255)
    geo = S.Geometric(p=max(float(pmf[0]), 1e-3))
    sched = SS.make_schedule("geometric_momentum", alpha, geo, mu_star=0.0, tau_max=255,
                             normalize_pmf=pmf)
    tr_a, losses_a, s_a = timed(sched.table)
    out = {"m": m, "steps": steps, "thresh": thresh}
    for tag, tr, losses, secs in (("const", tr_c, losses_c, s_c), ("mindthestep", tr_a, losses_a, s_a)):
        out[tag] = {"iters": iters_to(losses, thresh), "seconds": secs, "losses": losses,
                    "final_smoothed": float(np.convolve(losses, np.ones(25) / 25, "valid")[-1]),
                    "mean_tau": float(tr.taus.float().mean())}
    return out


def print_report(out: dict, logger=print) -> None:
    logger(f"CNN (fig-1 arch) on synthetic CIFAR-like data, m={out['m']} async workers:")
    for tag, label in (("const", "AsyncPSGD (const)"), ("mindthestep", "MindTheStep")):
        r = out[tag]
        it = r["iters"] if r["iters"] <= out["steps"] else f">{out['steps']}"
        logger(f"  {label:<22} final(sm) {r['final_smoothed']:.3f}  "
               f"iters-to-{out['thresh']}: {it}  mean tau {r['mean_tau']:.1f}  "
               f"({r['seconds']:.2f} s)")
    ic, ia = out["const"]["iters"], out["mindthestep"]["iters"]
    if ia < ic:
        logger(f"MindTheStep reached the threshold {ic / ia:.2f}x faster (iterations).")
    else:
        logger("No speedup at this configuration — try more workers (--m).")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--m", type=int, default=16, help="async workers")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=0.04)
    ap.add_argument("--image", type=int, default=16, help="image side (CIFAR=32)")
    ap.add_argument("--thresh", type=float, default=0.6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.steps, args.m, args.batch, args.alpha, args.image, args.thresh,
              device=args.device)
    print_report(out)
    return out


if __name__ == "__main__":
    main()
