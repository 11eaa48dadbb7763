"""Device layouts of the port (the counterpart of ``repro.launch.mesh``).

Two kinds of layout live here:

* :func:`make_workers_mesh`, the workers layout of the sharded async engine.
  The reference shards the simulated workers over a 1-D ``workers`` device
  mesh under ``shard_map``.  The port runs one process per device instead:
  a :class:`WorkersMesh` is this process's place among them, the
  ``torch.distributed`` process group (None for a single process), its rank
  and world size, and the device it computes on.  With ``R`` processes and
  ``W`` simulated workers (``W`` a multiple of ``R``), rank ``r`` owns
  workers ``[r W / R, (r + 1) W / R)``: their rings, samplers and histogram
  rows.
* :func:`make_production_mesh` / :func:`make_small_mesh`, the 2-D
  ``data x model`` layout of the sharding rules (:mod:`repro_torch.sharding`),
  of the dense layers' tensor parallelism and of the expert-parallel MoE.  A :class:`Mesh` carries what the specs
  read (``axis_names``, ``shape``, ``devices.shape``) and, when processes
  are running, one process group per axis.  Ranks are laid out row-major
  over the axes, as ``jax.make_mesh`` lays out devices: rank
  ``r = data_index * n_model + model_index``.

The reference's TPU layouts (a 16 x 16 pod, 2 x 16 x 16 over two pods) have
no H100 counterpart: the production layout here is one node of four cards
joined all to all by NVLink, and :data:`HARDWARE` holds the H100 SXM
figures the planner (:mod:`repro_torch.launch.dryrun`) uses.

The caller starts the processes and calls
``torch.distributed.init_process_group`` itself (nothing here reads a
cluster's environment); without an initialised group a layout describes
processes that are not running (planning, specs), or one process that owns
everything.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch

__all__ = ["WorkersMesh", "make_workers_mesh", "Mesh", "make_mesh", "make_production_mesh",
           "make_small_mesh", "HARDWARE", "hbm_bytes"]

# H100 SXM 80GB figures (NVIDIA's data sheet; dense rates, no sparsity, at the
# 700 W power limit), used by the roofline terms of the planner.
HARDWARE = {
    "name": "H100 SXM 80GB",
    "peak_flops_bf16": 989e12,  # per card, tensor cores
    "peak_flops_f32": 67e12,  # per card, outside the tensor cores
    "hbm_bandwidth": 3.35e12,  # bytes/s per card
    "nvlink_link_bandwidth": 25e9,  # bytes/s per link, each direction (NVLink 4)
    "nvlink_links_per_card": 18,
    "hbm_bytes": 80e9,  # the planner's constant for "fits"; hbm_bytes() reads the card
}


def hbm_bytes(device: Any = None) -> float:
    """Device memory of one card: read from the card when there is one,
    else the SXM 80 GB planning constant."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(device or 0).total_memory)
    return HARDWARE["hbm_bytes"]


@dataclasses.dataclass(frozen=True)
class WorkersMesh:
    group: Any  # torch.distributed process group; None for one process
    rank: int
    world_size: int
    device: torch.device

    def local_workers(self, W: int, rank: int | None = None) -> tuple[int, int]:
        """``(lo, hi)``: the workers this rank (or ``rank``) owns out of ``W``."""
        if W % self.world_size:
            raise ValueError(f"{W} workers do not split over {self.world_size} processes")
        per = W // self.world_size
        r = self.rank if rank is None else rank
        return r * per, (r + 1) * per


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


# ---------------------------------------------------------------------------
# The data x model layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """The shape of a layout's grid of cards (what ``mesh.devices`` gives the
    reference's specs: ``.shape`` and ``.size``)."""

    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of cards, and this process's place in it.

    ``shape`` maps each axis to its size.  ``groups`` maps a tuple of axis
    names to the process group of the ranks that differ only along those
    axes (this rank's group); it is empty when no processes are running.
    ``coords`` is this rank's index along each axis.  ``data_layouts``
    holds, by config and layout option, where a rank's param blocks sit
    once computed (:func:`repro_torch.sharding.collectives.data_layout`).
    """

    axis_names: tuple[str, ...]
    shape: dict
    rank: int = 0
    coords: dict = dataclasses.field(default_factory=dict)
    groups: dict = dataclasses.field(default_factory=dict)
    device: Any = None
    data_layouts: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def devices(self) -> DeviceGrid:
        return DeviceGrid(tuple(self.shape[a] for a in self.axis_names))

    @property
    def running(self) -> bool:
        """True when one process per card of the grid is running."""
        return bool(self.groups)

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (0 when not running)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords.get(a, 0)
        return idx

    def group(self, axes):
        """The process group over ``axes`` (its ranks differ only along them)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.groups[tuple(a for a in self.axis_names if a in axes)]

    def at(self, rank: int) -> "Mesh":
        """The layout as rank ``rank`` sees it (its coordinates; no groups):
        what a rank computes of another's blocks."""
        return dataclasses.replace(self, rank=rank, groups={},
                                   coords=_coords(rank, self.axis_names, self.shape))


def _coords(rank: int, axis_names, sizes) -> dict:
    """Rank ``rank``'s index along each axis, row-major over the axes."""
    coords, rest = {}, rank
    for a in reversed(axis_names):
        coords[a], rest = rest % sizes[a], rest // sizes[a]
    return {a: coords[a] for a in axis_names}


def _subsets(names):
    for n in range(1, len(names) + 1):
        yield from itertools.combinations(names, n)


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *, device: Any = "cuda") -> Mesh:
    """A layout of ``shape`` over ``axis_names``.

    With an initialised process group of exactly ``prod(shape)`` ranks it
    builds one group per subset of the axes (every rank calls
    ``new_group`` for every group, in the same order, as
    ``torch.distributed`` requires); with no group it describes the layout
    alone.  Each rank computes on ``cuda:rank`` modulo the visible cards
    (several ranks may share one card).
    """
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not match axes {axis_names}")
    sizes = dict(zip(axis_names, shape))
    n = math.prod(shape)
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(axis_names, sizes, device=torch.device(device))
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} layout needs {n} processes, but {world} are running")
    coords = _coords(rank, axis_names, sizes)
    groups = {}
    all_coords = list(itertools.product(*(range(s) for s in shape)))
    for axes in _subsets(axis_names):
        fixed = [a for a in axis_names if a not in axes]
        if not fixed:
            groups[axes] = dist.group.WORLD
            continue
        keys = sorted({tuple(c[axis_names.index(a)] for a in fixed) for c in all_coords})
        for key in keys:
            ranks = [r for r, c in enumerate(all_coords)
                     if tuple(c[axis_names.index(a)] for a in fixed) == key]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = g
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(axis_names, sizes, rank=rank, coords=coords, groups=groups, device=dev)


def make_production_mesh(*, cards: int = 4, device: Any = "cuda") -> Mesh:
    """One node: ``data 1 x model cards`` (4 H100s joined by NVLink)."""
    return make_mesh((1, cards), ("data", "model"), device=device)


def make_small_mesh(data: int = 2, model: int = 2, *, device: Any = "cuda") -> Mesh:
    """The CI layout: ``data 2 x model 2`` (4 gloo processes on the CPU)."""
    return make_mesh((data, model), ("data", "model"), device=device)
