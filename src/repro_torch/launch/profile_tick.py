"""Where a tick's time goes: the main path under ``torch.profiler`` on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_tick --ticks 3 \\
        [--layers 24] [--out tick_trace.json]

Builds the same run as ``chip_smoke.py``'s main path (full-width
stablelm-1.6b, async fused momentum, W = 8, K = 8 bf16 ring, batch 4 x seq
512), runs two warm-up ticks, then profiles ``--ticks`` ticks and prints:
the wall time per tick, the device-busy share (summed device-op time over
wall time; ops on one stream do not overlap), the device ops per tick, the
kernels that took the most device time and the host ops that took the most
CPU time.  ``--out`` also writes the Chrome trace.  Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def print_profile(prof, wall: float, n: int, unit: str, top: int) -> None:
    """Wall and device-busy time per ``unit``, device ops per ``unit``, the
    kernels with the most device time and the host ops with the most CPU time."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in on_device)
    launches = sum(e.count for e in on_device)
    print(f"wall {wall * 1e3 / n:.1f} ms/{unit}  device busy {device_us / 1e3 / n:.1f} ms/{unit} "
          f"({100 * device_us / 1e6 / wall:.1f}% of wall)  {launches / n:.0f} device ops/{unit}")
    print(f"{'device ms/' + unit:>16} {'calls/' + unit:>12}  kernel")
    for e in sorted(on_device, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"{e.self_device_time_total / 1e3 / n:16.3f} {e.count / n:12.1f}  {e.key[:110]}")
    host = [e for e in events if e.device_type == DeviceType.CPU]
    print(f"{'host ms/' + unit:>16} {'calls/' + unit:>12}  op (self CPU time)")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[: top // 2]:
        print(f"{e.self_cpu_time_total / 1e3 / n:16.3f} {e.count / n:12.1f}  {e.key[:110]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None, help="write the Chrome trace here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.optim import transform as T
    from repro_torch.run.engine import make_engine
    from repro_torch.run.spec import RunSpec
    from repro_torch.training import default_adapt_setup

    if not torch.cuda.is_available():
        raise SystemExit("profile_tick needs a CUDA device")
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), num_layers=args.layers)
    sched, _, adapt = default_adapt_setup(0.01, 8, 8)
    pipe = T.chain(T.scale_by_staleness(sched, 0.01, m=8, tau_max=adapt.tau_max),
                   T.scale(-0.01), T.trace(0.9))
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=2 + args.ticks, batch_size=4,
                   seq_len=512, num_workers=8, ring=8, ring_dtype="bfloat16", adapt=adapt,
                   fuse=True, seed=0, device="cuda")
    engine = make_engine(spec)
    state = engine.build()
    batches = spec.batch_stream()
    for _ in range(2):
        state, _ = engine.tick(state, next(batches))
    ready = [next(batches) for _ in range(args.ticks)]  # data made before the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in ready:
            state, _ = engine.tick(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"layers={args.layers} ticks={args.ticks}")
    print_profile(prof, wall, args.ticks, "tick", args.top)
    if args.out:
        prof.export_chrome_trace(args.out)
        print(f"trace -> {args.out}")


if __name__ == "__main__":
    main()
