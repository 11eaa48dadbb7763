"""The workers layout of the sharded async engine (the counterpart of
``repro.launch.mesh.make_workers_mesh``).

The reference shards the simulated workers over a 1-D ``workers`` device
mesh under ``shard_map``.  The port runs one process per device instead:
:func:`make_workers_mesh` describes this process's place among them — the
``torch.distributed`` process group (None for a single process), its rank
and world size, and the device it computes on.  With ``R`` processes and
``W`` simulated workers (``W`` a multiple of ``R``), rank ``r`` owns workers
``[r W / R, (r + 1) W / R)``: their rings, samplers and histogram rows.

The caller starts the processes and calls
``torch.distributed.init_process_group`` itself (nothing here reads a
cluster's environment); without an initialised group the layout is one
process that owns every worker.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["WorkersMesh", "make_workers_mesh"]


@dataclasses.dataclass(frozen=True)
class WorkersMesh:
    group: Any  # torch.distributed process group; None for one process
    rank: int
    world_size: int
    device: torch.device

    def local_workers(self, W: int) -> tuple[int, int]:
        """``(lo, hi)``: the workers this rank owns out of ``W``."""
        if W % self.world_size:
            raise ValueError(f"{W} workers do not split over {self.world_size} processes")
        per = W // self.world_size
        return self.rank * per, (self.rank + 1) * per


def make_workers_mesh(devices: int | None = None, *, device: Any = "cuda") -> WorkersMesh:
    """This process's place in the workers layout.

    ``devices`` is the number of processes the caller expects (None: the
    initialised group's size, or 1 without one); a mismatch raises.  With
    more than one process on the card, each rank takes ``cuda:rank`` modulo
    the visible cards.
    """
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    if devices is not None and devices != world:
        raise ValueError(f"asked for a {devices}-process workers mesh, but {world} "
                         "process(es) are running")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and world > 1:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return WorkersMesh(group=group if world > 1 else None, rank=rank, world_size=world,
                       device=dev)
