"""Training launcher of the port (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 20 --batch 4 --seq 64 --reduced --async_psgd --workers 8 \\
        --ring 8 --refresh_every 10 --fuse --momentum 0.9

Runs on the card by default (``--device cpu`` for a CPU run of ``--reduced``).
The MindTheStep configuration is the reference's: a Poisson(workers)
staleness model, the eq.-17 step size with K = alpha_c normalized per eq. 26,
clip at 5 alpha_c, drop tau > 150.  ``--fuse`` lowers the pipeline to the
hand-written fused kernels (one ``fused_tick`` launch per async tick);
``--fused`` applies through the ``fused_apply`` link (the ``fused_update``
kernel).  The full-width model on one 80 GB card needs the fused layout and
a short low-precision ring: ``--fuse --ring 8 --ring_dtype bfloat16``.

The live parameter server: ``--engine distributed --workers W --transport
inproc|socket`` runs W real workers (threads moving device tensors, or
spawned processes over localhost TCP) against a serial-apply server, with
the staleness measured; ``--trace_out PATH`` streams it to an events-format
trace and prints a best-fit staleness model after the run; ``--faults``
injects faults (``repro_torch.distributed.faults.parse_faults`` syntax) and
``--worker_timeout`` arms the server's liveness sweep.  The three need
``--engine distributed``.

Checkpoint and resume: ``--checkpoint_dir D --checkpoint_every N`` saves the
full state every N steps (device state and the estimator's host half);
rerunning with ``--resume`` (and a larger ``--steps``) prints ``resuming at
step K`` and continues bit-identically to an uninterrupted run.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.distributed.transport import transport_kinds
from repro_torch.optim import transform as T
from repro_torch.run import CheckpointHook, LogHook, RunSpec, run
from repro_torch.training import default_adapt_setup


def _mode(args) -> str:
    return args.engine or ("async" if args.async_psgd else "sync")


def build_spec(args) -> RunSpec:
    mode = _mode(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.fused:
        mu = 0.9 if args.momentum is None else args.momentum
        base_links = (T.fused_apply(args.lr, mu),)
    elif args.momentum is not None:
        base_links = (T.scale(-args.lr), T.trace(args.momentum))
    else:
        base_links = (T.scale(-args.lr),)
    adapt = None
    # the live and the simulated async engines share the MindTheStep pipeline
    if args.async_psgd or mode in ("async", "distributed"):
        sched, _model, adapt = default_adapt_setup(args.lr, args.workers, args.ring,
                                                   device=args.device)
        link = T.scale_by_staleness(sched, args.lr, m=args.workers, tau_max=adapt.tau_max)
        pipeline = T.chain(link, *base_links)
    else:
        pipeline = T.chain(*base_links)
    return RunSpec(
        cfg=cfg, pipeline=pipeline, mode=mode, num_steps=args.steps,
        batch_size=args.batch, seq_len=args.seq, num_workers=args.workers,
        ring=args.ring if mode == "async" else 0, ring_dtype=args.ring_dtype,
        adapt=adapt, fuse=args.fuse, refresh_every=args.refresh_every,
        seed=args.seed, device=args.device, transport=args.transport,
        trace_path=args.trace_out, faults=args.faults, worker_timeout=args.worker_timeout,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b", choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--reduced", action="store_true", help="small same-family variant")
    ap.add_argument("--async_psgd", action="store_true", help="MindTheStep async step")
    ap.add_argument("--engine", default=None, choices=["sync", "async", "distributed"],
                    help="engine mode override; 'distributed' runs the live parameter "
                         "server: --workers real workers over --transport")
    ap.add_argument("--transport", default="inproc", choices=list(transport_kinds()),
                    help="distributed worker fabric: threads, or TCP + spawned processes")
    ap.add_argument("--trace_out", default=None,
                    help="stream the live run's measured staleness to this trace file "
                         "(distributed engine only)")
    ap.add_argument("--faults", default=None,
                    help="fault injection for the live parameter server, e.g. "
                         "'crash_before_push:worker=1:after=2,delay_push:worker=0:seconds=0.2' "
                         "(distributed engine only)")
    ap.add_argument("--worker_timeout", type=float, default=None,
                    help="seconds of worker silence after taking work before the server "
                         "reclaims its batch (distributed engine only)")
    ap.add_argument("--workers", type=int, default=16, help="modeled async workers m")
    ap.add_argument("--ring", type=int, default=16, help="delayed-gradient ring size")
    ap.add_argument("--ring_dtype", default=None, choices=["float32", "bfloat16"])
    ap.add_argument("--refresh_every", type=int, default=0, help="online refit cadence")
    ap.add_argument("--fused", action="store_true", help="fused_apply link (fused_update kernel)")
    ap.add_argument("--fuse", action="store_true", help="lower the pipeline to the fused kernels")
    ap.add_argument("--momentum", type=float, default=None,
                    help="heavy-ball mu (adds the trace link; 0.9 by default with --fused)")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="full-fidelity checkpoint directory (enables saving)")
    ap.add_argument("--checkpoint_every", type=int, default=0,
                    help="save cadence in steps (requires --checkpoint_dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --checkpoint_dir "
                         "(bit-identical to the uninterrupted run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint_dir")
    if args.checkpoint_every and not args.checkpoint_dir:
        ap.error("--checkpoint_every requires --checkpoint_dir")
    if args.checkpoint_dir and not args.checkpoint_every and not args.resume:
        ap.error(
            "--checkpoint_dir does nothing without --checkpoint_every N "
            "(to save) and/or --resume (to restore)"
        )
    mode = _mode(args)
    if args.trace_out and mode != "distributed":
        ap.error("--trace_out needs --engine distributed (live staleness capture)")
    if args.faults and mode != "distributed":
        ap.error("--faults needs --engine distributed (live fault injection)")
    if args.worker_timeout is not None and mode != "distributed":
        ap.error("--worker_timeout needs --engine distributed (server liveness)")
    spec = build_spec(args)
    print(f"arch={spec.cfg.name} layers={spec.cfg.num_layers} mode={spec.mode} "
          f"fused={args.fused} fuse={args.fuse} device={args.device}")
    if args.resume:
        from repro_torch.checkpoint import latest_step

        try:
            at = latest_step(args.checkpoint_dir)
        except FileNotFoundError:
            raise SystemExit(
                f"--resume: no checkpoint found under {args.checkpoint_dir!r} "
                "(no 'latest' pointer — did a previous run save with "
                "--checkpoint_every?)"
            ) from None
        if at > args.steps:
            raise SystemExit(
                f"--resume: checkpoint is at step {at} but --steps is "
                f"{args.steps}; pass --steps >= {at} to continue the run"
            )
        print(f"resuming at step {at} from {args.checkpoint_dir}")
    hooks = [LogHook(log_every=max(args.steps // 10, 1))]
    if args.checkpoint_dir and args.checkpoint_every:
        hooks.append(CheckpointHook(args.checkpoint_dir, every=args.checkpoint_every))
    result = run(spec, hooks=hooks, resume_from=args.checkpoint_dir if args.resume else None)
    if not result.history:
        print(f"nothing to do: checkpoint already at step {result.step} of {args.steps}")
        return result
    if spec.adapt is not None and args.refresh_every:
        est = T.staleness_link(spec.pipeline).estimator
        print(f"online estimator: lam={est.fit('poisson').lam:.2f} (m={args.workers}), "
              f"n_seen={est.n_seen}")
    if args.trace_out:
        _report_trace(args.trace_out, args.workers)
    if result.history:
        print(f"final loss: {result.history[-1]['loss']:.4f}")
    return result


def _report_trace(path: str, workers: int) -> None:
    """The live trace's tau mean, round-trip latency and best-fit model."""
    import numpy as np

    from repro_torch.async_engine.events import load_trace
    from repro_torch.core.staleness import fit_all_models

    taus, _who, t_pull, t_push = load_trace(path, return_workers=True, return_times=True)
    fits = fit_all_models(taus, m=workers)
    name, (_, dist) = min(fits.items(), key=lambda kv: kv[1][1])
    latency = ""
    if t_pull is not None and len(taus):
        latency = f"  latency mean={float(np.mean(t_push - t_pull)) * 1e3:.1f}ms"
    print(f"live trace: {len(taus)} updates -> {path}  tau mean={float(np.mean(taus)):.2f}"
          f"{latency}  best model={name} (Bhattacharyya {dist:.4f})")


if __name__ == "__main__":
    main()
