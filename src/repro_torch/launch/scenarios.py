"""Scenario-matrix runner: {arch} x {staleness model} x {strategy} x
{optimizer} (the counterpart of ``repro.launch.scenarios``).

    PYTHONPATH=src python -m repro_torch.launch.scenarios --smoke
    PYTHONPATH=src python -m repro_torch.launch.scenarios \\
        --archs stablelm-1.6b,recurrentgemma-9b --staleness geometric,cmp,trace \\
        --strategies fixed,eq17,eq26 --optims sgd,adam --steps 20 \\
        --out build/BENCH_scenarios.json

Each cell is one :class:`~repro_torch.run.RunSpec` run by the One Run API
(:func:`repro_torch.run.run`) through the SHARDED async engine (per-worker
rings and heterogeneous tau samplers, the workers split over the processes
of a :class:`~repro_torch.launch.mesh.WorkersMesh`); a
:class:`~repro_torch.run.BenchHook` emits the cell's bench.v1 rows: final
loss with the loss-vs-updates series in ``meta``, and wall-clock.  The port
runs eagerly, so there is no retrace row.

Staleness models are heterogeneous ACROSS workers within each family —
per-worker geometric p / Poisson lambda / CMP nu spreads, and per-worker
event-simulator traces for ``trace`` — the model- and scale-dependence of
the paper's staleness distribution.  A cell's optimizer is its base links
(``chain(scale(-lr))`` for ``sgd``, ``chain(scale_by_adam(), scale(-lr))``
for ``adam``) handed to the one ``make_step`` factory.

Runs on the card by default (``--device cpu`` for a CPU run).  The rows go
to ``--out`` (default ``build/BENCH_scenarios.json``, an untracked path).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from repro_torch.async_engine.events import EventSimConfig, simulate_staleness_trace
from repro_torch.bench_schema import write_bench_json
from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_configs, reduced
from repro_torch.core.staleness import CMP, Geometric, Poisson
from repro_torch.core.step_size import make_schedule
from repro_torch.data import make_batch_for
from repro_torch.launch.mesh import make_workers_mesh
from repro_torch.optim import transform as T
from repro_torch.run import BenchHook, RunSpec, run
from repro_torch.training import make_worker_adapt

STALENESS_FAMILIES = ("geometric", "poisson", "cmp", "trace")
STRATEGY_CHOICES = ("fixed", "eq17", "eq26")
OPTIM_CHOICES = ("sgd", "adam")

SMOKE_ARCHS = ("stablelm-1.6b", "recurrentgemma-9b")
SMOKE_STALENESS = ("geometric", "trace")
SMOKE_STRATEGIES = ("eq26",)
SMOKE_OPTIMS = ("sgd", "adam")
DEFAULT_OUT = os.path.join("build", "BENCH_scenarios.json")


@dataclasses.dataclass(frozen=True)
class ScenarioCell:
    arch: str
    staleness: str
    strategy: str
    optim: str = "sgd"
    workers: int = 4
    ring: int = 8
    steps: int = 6
    batch: int = 2
    seq: int = 16
    d_model: int = 128
    lr: float = 0.05
    seed: int = 0

    @property
    def name(self) -> str:
        return f"scenarios/{self.arch}/{self.staleness}/{self.strategy}/{self.optim}"

    def config(self) -> dict:
        return dataclasses.asdict(self)


def worker_models(cell: ScenarioCell) -> list:
    """Heterogeneous per-worker staleness samplers for one cell."""
    W, m = cell.workers, float(cell.workers)
    if cell.staleness == "geometric":
        # mean staleness spread ~ [m/2, 3m/2] across workers: p = 1/(1+mean)
        means = np.linspace(0.5 * m, 1.5 * m, W)
        return [Geometric(p=1.0 / (1.0 + mu)) for mu in means]
    if cell.staleness == "poisson":
        return [Poisson(lam=lam) for lam in np.linspace(0.5 * m, 1.5 * m, W)]
    if cell.staleness == "cmp":
        # fixed mode m (eq. 13), per-worker decay rate nu
        return [CMP.from_mode(cell.workers, nu) for nu in np.linspace(0.7, 1.6, W)]
    if cell.staleness == "trace":
        # event-simulated traces, one per worker (distinct seeds + jitter)
        return [
            simulate_staleness_trace(
                EventSimConfig(m=cell.workers, jitter=0.01 * w),
                num_updates=256,
                seed=cell.seed + 17 * w,
            )
            for w in range(W)
        ]
    raise ValueError(f"unknown staleness family {cell.staleness!r}")


def cell_schedule(cell: ScenarioCell):
    """fixed / eq.-17 / eq.-26-normalized step-size schedule for one cell."""
    tau_max = 4 * cell.ring
    if cell.strategy == "fixed":
        return make_schedule("constant", cell.lr, tau_max=tau_max)
    model = Poisson(float(cell.workers))
    if cell.strategy == "eq17":
        return make_schedule("poisson_momentum", cell.lr, model, K=cell.lr, tau_max=tau_max)
    if cell.strategy == "eq26":
        pmf = model.pmf_table(cell.ring - 1)
        return make_schedule(
            "poisson_momentum", cell.lr, model, K=cell.lr,
            tau_max=tau_max, normalize_pmf=pmf / np.sum(pmf),
        )
    raise ValueError(f"unknown strategy {cell.strategy!r}")


def cell_pipeline(cell: ScenarioCell, sched) -> T.Chain:
    """The cell's full update pipeline: staleness link + optimizer links."""
    staleness = T.scale_by_staleness(sched, cell.lr)
    if cell.optim == "sgd":
        return T.chain(staleness, T.scale(-cell.lr))
    if cell.optim == "adam":
        return T.chain(staleness, T.scale_by_adam(), T.scale(-cell.lr))
    raise ValueError(f"unknown optimizer {cell.optim!r}")


def run_cell(cell: ScenarioCell, mesh=None, *, device="cuda", params=None,
             tau_source=None) -> list[dict]:
    """Train one matrix cell through the Run API; returns its bench rows.
    ``params`` and ``tau_source`` let a test start from another run's params
    and replay its uniforms."""
    mesh = make_workers_mesh(device=device) if mesh is None else mesh
    cfg = reduced(get_config(cell.arch), d_model=cell.d_model)
    sched = cell_schedule(cell)
    adapt = make_worker_adapt(sched.table, worker_models(cell), cdf_support=cell.ring)
    spec = RunSpec(
        cfg=cfg,
        pipeline=cell_pipeline(cell, sched),
        mode="sharded_async",
        num_steps=cell.steps,
        batch_fn=lambda t: make_batch_for(cfg, batch=cell.batch, seq=cell.seq,
                                          seed=cell.seed + t, device=device),
        ring=cell.ring,
        adapt=adapt,
        mesh=mesh,
        params=params,
        tau_source=tau_source,
        device=device,
        seed=cell.seed,
    )
    bench = BenchHook(cell.name, cell.config())
    run(spec, hooks=[bench])
    return bench.rows


def run_matrix(cells: list[ScenarioCell], out: str, logger=print, *,
               device="cuda") -> list[dict]:
    mesh = make_workers_mesh(device=device)
    rows: list[dict] = []
    failures: list[str] = []
    for cell in cells:
        try:
            cell_rows = run_cell(cell, mesh, device=device)
        except Exception as e:  # noqa: BLE001 — the matrix reports every cell
            failures.append(f"{cell.name}: {e!r}")
            logger(f"!! {cell.name} FAILED: {e!r}")
            continue
        rows.extend(cell_rows)
        logger(f"{cell.name:<56} loss {cell_rows[0]['value']:.4f} "
               f"wall {cell_rows[1]['value']:5.1f}s")
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    write_bench_json(out, rows)
    logger(f"wrote {len(rows)} rows ({len(cells) - len(failures)} cells) -> {out}")
    if failures:
        raise SystemExit("scenario cells failed:\n  " + "\n  ".join(failures))
    return rows


def build_cells(args) -> list[ScenarioCell]:
    return [
        ScenarioCell(
            arch=a, staleness=s, strategy=st, optim=o,
            workers=args.workers, ring=args.ring, steps=args.steps,
            batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
        )
        for a in args.archs
        for s in args.staleness
        for st in args.strategies
        for o in args.optims
    ]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--archs", default=",".join(SMOKE_ARCHS),
                    help=f"comma-separated, from the port's archs: {', '.join(ASSIGNED_ARCHS)}")
    ap.add_argument("--staleness", default=",".join(SMOKE_STALENESS))
    ap.add_argument("--strategies", default=",".join(SMOKE_STRATEGIES))
    ap.add_argument("--optims", default="sgd")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--ring", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI cell set (2 archs x 2 models x 2 optims)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.smoke:
        args.archs = ",".join(SMOKE_ARCHS)
        args.staleness = ",".join(SMOKE_STALENESS)
        args.strategies = ",".join(SMOKE_STRATEGIES)
        args.optims = ",".join(SMOKE_OPTIMS)
    args.archs = [a for a in args.archs.split(",") if a]
    args.staleness = [s for s in args.staleness.split(",") if s]
    args.strategies = [s for s in args.strategies.split(",") if s]
    args.optims = [o for o in args.optims.split(",") if o]
    for a in args.archs:
        if a not in list_configs():
            ap.error(f"arch {a!r} is not ported (no such registered arch); the port runs "
                     f"{', '.join(ASSIGNED_ARCHS)}")
    for s in args.staleness:
        if s not in STALENESS_FAMILIES:
            ap.error(f"unknown staleness family {s!r}; choose from {STALENESS_FAMILIES}")
    for s in args.strategies:
        if s not in STRATEGY_CHOICES:
            ap.error(f"unknown strategy {s!r}; choose from {STRATEGY_CHOICES}")
    for o in args.optims:
        if o not in OPTIM_CHOICES:
            ap.error(f"unknown optimizer {o!r}; choose from {OPTIM_CHOICES}")
    return run_matrix(build_cells(args), args.out, device=args.device)


if __name__ == "__main__":
    main()
