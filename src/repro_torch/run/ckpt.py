"""Full-fidelity checkpoint/resume for the Run API (port of
``src/repro/run/ckpt.py``).

A checkpoint must capture *everything* the next step reads, or the resumed
trajectory diverges.  Two halves:

* **Device state** — the whole :class:`~repro_torch.training.steps.TrainState`:
  params (flat-native under ``fuse``), optimizer state (including the fused
  ``{"p", "bufs"}`` layout), the delayed ring (per-leaf or flat ``(K, N)``),
  the ``AdaptState`` tables *and the device histogram*, the step counter and
  the workers' generator.  Saved through :mod:`repro_torch.checkpoint.store`
  (key-path-named npz; restore validates structure against the engine-built
  template).
* **Host state** — the adaptation loop's host half, which lives on the
  pipeline object between steps: the online estimator's float64 histogram +
  sample count, and the staleness link's current schedule table.  Saved as a
  small sidecar npz and restored by *mutating the live pipeline*, leniently
  on shape (a refresh may legitimately resize the host table) but strictly
  on estimator support.

With both halves restored, a resumed run is bit-identical to the
uninterrupted one in both engine modes, fused and unfused — including runs
whose resume point crosses a ``refresh_every`` boundary (the partial device
histogram and the estimator counts both round-trip).  Enforced by
tests/test_torch_resume.py, and on the card at full width by
``chip_smoke.py``.

**A multi-process run** (a rank's state under a running ``data x model``
mesh, or the sharded engine's over a multi-process workers layout) saves
ONE checkpoint, the one the same config writes in one process: the same
names, the flat ``(N,)`` order of ``param_template``, the ring as
``(K, N)`` or ``(W, K, N)``.  A :class:`StateLayout` (from the engine,
``engine.checkpoint_layout()``) says where each leaf of a rank's state sits
in that one-process state.  The save streams each leaf chunk by chunk to
global rank 0, which alone writes (:func:`~repro_torch.sharding.collectives.gather_to_writer`:
every element from the rank that owns it, as bits); the replicated leaves
(step, generator, tables, host sidecar) are first held equal on every rank.
The ``latest`` pointer moves last, after a barrier.  A restore streams the
same file on every rank, each keeping its own blocks
(:func:`~repro_torch.sharding.specs.block_part`), so a checkpoint restores
at any layout, in one process, and in the reference (every leaf but
``.rng``).  Enforced by tests/test_torch_tp_checkpoint.py, and on the card
by ``chip_smoke.py`` phase 16.
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
import os
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import store as S
from repro_torch.checkpoint.store import load_train_state, save_train_state

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "refresh_link_of",
    "StateLayout",
    "tensor_parallel_layout",
    "workers_layout",
]


def refresh_link_of(pipeline) -> Any | None:
    """The host-adaptation handle of ``pipeline``: its ``scale_by_staleness``
    link, or any object carrying an ``estimator`` itself.  None when the
    pipeline carries no host-side adaptation state.

    This is THE resolution — the refresh boundary
    (:func:`repro_torch.run.engine._refresher_of`) resolves through it too,
    so the object the checkpoint persists is always the object a refresh
    mutates.
    """
    from repro_torch.optim import transform as T

    if pipeline is None:
        return None
    if isinstance(pipeline, T.GradientTransform):
        return T.staleness_link(pipeline)
    return pipeline if hasattr(pipeline, "estimator") else None


# ---------------------------------------------------------------------------
# Where a rank's leaves sit in the one-process state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of a leaf's elements that one rule places: its index space in
    the whole leaf (an SSM ``in_proj``'s last dim as ``(2, d_inner)``), by
    rank the box the rank holds (``(offsets, lengths)``) and whether it
    writes that box at a save, and this rank's box as a view of its own
    leaf."""

    shape: tuple[int, ...]
    boxes: tuple
    owners: tuple[bool, ...]
    local: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's segments, in the whole leaf's order.  ``replicated``: every
    rank holds the whole leaf, which a save first holds equal across ranks."""

    segments: tuple[Segment, ...]
    replicated: bool = False


def _whole(shape: tuple[int, ...], world: int) -> Segment:
    """The whole leaf, held by every rank and written by rank 0."""
    box = ((0,) * len(shape), tuple(shape))
    return Segment(tuple(shape), (box,) * world, tuple(r == 0 for r in range(world)),
                   lambda t: t)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.get_state().shape if isinstance(leaf, torch.Generator) else leaf.shape)


class StateLayout:
    """How each rank's state of a multi-process run sits in the one-process
    state of the same run (module docstring).  ``whole`` is the one-process
    state's shape-only template, ``rank`` / ``world`` this process's place
    among all of them, ``group`` the group of all of them (gloo: the gather
    moves CPU tensors),
    ``place(key, whole_leaf, local_leaf)`` each leaf's :class:`Placement`
    (default: replicated)."""

    def __init__(self, whole: Any, rank: int, world: int, group: Any,
                 place: Callable[[str, Any, Any], Placement | None]):
        self.whole, self.rank, self.world, self.group = whole, rank, world, group
        self._place = place

    @property
    def writer(self) -> bool:
        from repro_torch.sharding.collectives import WRITER

        return self.rank == WRITER

    def place(self, key: str, whole_leaf, local_leaf) -> Placement:
        got = None if isinstance(local_leaf, torch.Generator) else self._place(
            key, whole_leaf, local_leaf)
        return got or Placement((_whole(_shape(whole_leaf), self.world),), replicated=True)

    def placements(self, local: Any) -> list[tuple[str, tuple[int, ...], Any, Placement]]:
        """``(key, whole shape, leaf, placement)`` for every leaf of
        ``local`` (a rank's state or its template), in the one-process
        state's order."""
        whole = dict(S.key_paths(self.whole))
        pairs = list(S.key_paths(local))
        if [k for k, _ in pairs] != list(whole):
            raise ValueError("the rank's state does not have the one-process state's leaves: "
                             f"{[k for k, _ in pairs]} != {list(whole)}")
        return [(k, _shape(whole[k]), leaf, self.place(k, whole[k], leaf)) for k, leaf in pairs]

    def barrier(self) -> None:
        torch.distributed.barrier(group=self.group)


def tensor_parallel_layout(cfg, mesh, whole: Any, over: dict[str, tuple]) -> StateLayout:
    """The layout of a rank's state under a running ``data x model`` mesh.
    ``over`` (:func:`~repro_torch.training.steps.over_params` of the rank's
    state, from the engine that built it) names the leaves that hold the
    rank's blocks of the params, leaf by leaf or as a flat buffer packed
    from :func:`~repro_torch.sharding.specs.local_template` (cut here with
    :func:`~repro_torch.optim.transform.flat_view`, the builder's own
    packing); each block is written by its owner
    (:func:`~repro_torch.sharding.specs.owns_block`).  Every other leaf is
    replicated, and must have its one-process shape."""
    from repro_torch.optim.transform import flat_view
    from repro_torch.sharding.specs import block_box, local_template, owns_block, storage_spec_for
    from repro_torch.training.steps import param_template
    from repro_torch.tree import tree_map, tree_paths

    views = [mesh.at(r) for r in range(mesh.devices.size)]
    params = {}  # path: (index shape, boxes by rank, owners by rank)
    for path, (shape, _) in tree_paths(param_template(cfg)):
        name = "/".join(path)
        spec = storage_spec_for(name, tuple(shape), mesh, cfg)
        boxes = [block_box(tuple(shape), spec, v, name) for v in views]
        params[path] = (boxes[0][0], tuple(b[1:] for b in boxes),
                        tuple(owns_block(spec, v) for v in views))
    template = tree_map(lambda leaf: (leaf[0], torch.float32), local_template(cfg, mesh))
    local = list(tree_paths(template))
    # where each leaf's block starts in the rank's flat buffer, as the builder packs it
    packed = flat_view(torch.empty(sum(math.prod(s) for _, (s, _) in local), device="meta"),
                       template)
    starts = [v.storage_offset() for _, v in tree_paths(packed)]

    def leafwise(lead, index_shape, boxes, owners):
        pad = (0,) * len(lead)
        mine = lead + boxes[mesh.rank][1]
        return Segment(lead + index_shape, tuple((pad + o, lead + n) for o, n in boxes), owners,
                       lambda t: t.view(mine))

    def flat(lead):
        for idx in itertools.product(*(range(n) for n in lead)):
            for (path, (shape, _)), a in zip(local, starts):
                index_shape, boxes, owners = params[path]
                yield Segment(index_shape, boxes, owners,
                              lambda t, idx=idx, a=a, b=a + math.prod(shape),
                              mine=boxes[mesh.rank][1]: t[idx][a:b].view(mine))

    def place(key, w, leaf):
        got = over.get(key)
        if got is None:
            if tuple(w.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {key}: the rank holds {tuple(leaf.shape)} of the "
                                 f"one-process state's {tuple(w.shape)}, but it is not over the "
                                 "params")
            return None
        path, n_lead = got
        lead = tuple(w.shape[:n_lead])
        if path is None:
            return Placement(tuple(flat(lead)))
        return Placement((leafwise(lead, *params[path]),))

    return StateLayout(whole, mesh.rank, mesh.devices.size, mesh.group(mesh.axis_names), place)


def workers_layout(mesh, num_workers: int, whole: Any) -> StateLayout:
    """The layout of a rank's state of the sharded engine over a
    multi-process workers mesh: the ring's leading dim holds the rank's own
    workers (:meth:`~repro_torch.launch.mesh.WorkersMesh.local_workers`),
    each worker's histogram row is written by its rank (a rank records
    only its own rows, and a restore gives it back only those: the merged
    sum counts every tau once), the params and their optimizer state are
    the same on every rank and written by rank 0; every other leaf is
    replicated."""
    spans = [mesh.local_workers(num_workers, r) for r in range(mesh.world_size)]
    lo, hi = spans[mesh.rank]

    def rows(shape, local):
        boxes = tuple(((a,) + (0,) * (len(shape) - 1), (b - a,) + shape[1:]) for a, b in spans)
        return Placement((Segment(shape, boxes, (True,) * len(spans), local),))

    def place(key, w, _local):
        shape = tuple(w.shape)
        if key.startswith(".delayed.ring"):
            return rows(shape, lambda t: t)
        if key == ".adapt.hist":
            return rows(shape, lambda t: t[lo:hi])
        if key.startswith((".params", ".opt_state")):
            return Placement((_whole(shape, mesh.world_size),))
        return None

    return StateLayout(whole, mesh.rank, mesh.world_size, mesh.group, place)


# ---------------------------------------------------------------------------
# Save and restore
# ---------------------------------------------------------------------------

def _host_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}_host.npz")


def _host_state(pipeline) -> dict[str, np.ndarray]:
    link = refresh_link_of(pipeline)
    host: dict[str, np.ndarray] = {}
    if link is not None:
        sched = getattr(link, "schedule", None)
        if sched is not None:
            host["schedule_table"] = np.asarray(sched.table, np.float64)
        est = getattr(link, "estimator", None)
        if est is not None:
            host["est_counts"] = np.asarray(est.counts, np.float64)
            host["est_n_seen"] = np.int64(est.n_seen)
    return host


def _digest(t) -> str:
    """SHA-256 of a leaf's bits (a generator's state, a tensor, an array)."""
    if isinstance(t, torch.Generator):
        t = t.get_state()
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(t).tobytes()).hexdigest()


def _leaf_stream(layout: StateLayout, key: str, whole: tuple[int, ...], leaf,
                 placement: Placement) -> S.LeafStream:
    """A rank's leaf as the writer streams it: each chunk of the whole leaf
    gathered from its owners (every rank runs it in step)."""
    from repro_torch.sharding.collectives import gather_to_writer
    from repro_torch.sharding.specs import block_part

    gen = leaf.device.type if isinstance(leaf, torch.Generator) else None
    t = leaf.get_state() if gen else leaf.detach()

    def pieces():
        for seg in placement.segments:
            block = seg.local(t)
            for run in S.runs(seg.shape, t.element_size()):
                parts, mine = [], None
                for r, (box, own) in enumerate(zip(seg.boxes, seg.owners)):
                    part = block_part(run, *box) if own else None
                    if part is not None:
                        parts.append((r, part[0]))
                        if r == layout.rank:
                            mine = block[part[1]]
                yield S.run_shape(seg.shape, run), t.dtype, parts, mine

    chunks = gather_to_writer(pieces(), layout.rank, layout.group)
    return S.LeafStream(key, whole, t.dtype, chunks, gen)


def _save_sharded(directory: str, state: Any, step: int, layout: StateLayout,
                  host: dict[str, np.ndarray]) -> None:
    from repro_torch.sharding.collectives import check_same_on_every_rank

    leaves = layout.placements(state)
    digests = {k: _digest(leaf) for k, _, leaf, p in leaves if p.replicated}
    digests.update({f"host sidecar [{k!r}]": _digest(v) for k, v in host.items()})
    check_same_on_every_rank(digests, layout.group)
    if layout.writer:
        _write_host(directory, step, host)
    streams = (_leaf_stream(layout, *leaf) for leaf in leaves)
    if layout.writer:
        S.write_pytree(S.step_path(directory, step), streams)
    else:
        for stream in streams:
            for _ in stream.chunks:
                pass
    layout.barrier()  # every part is in
    if layout.writer:
        S.set_latest(directory, step)
    layout.barrier()


def _restore_sharded(directory: str, template: Any, step: int, layout: StateLayout,
                     device: Any) -> Any:
    """Every rank streams the one-process checkpoint and keeps its blocks."""
    from repro_torch.sharding.specs import block_part

    local = {k: (leaf, p) for k, _, leaf, p in layout.placements(template)}

    def take(key, _whole_ref, member):
        ref, placement = local[key]
        if isinstance(ref, torch.Generator):
            return S.restore_generator(ref, member)
        target = ref.device if ref.device.type != "meta" else torch.device(device)
        out = torch.zeros(tuple(ref.shape), dtype=ref.dtype, device=target)
        for seg in placement.segments:
            box = seg.boxes[layout.rank]
            block = seg.local(out)
            for run in S.runs(seg.shape, member.np_dtype.itemsize):
                shape = S.run_shape(seg.shape, run)
                part = block_part(run, *box)
                if part is None:
                    member.skip(math.prod(shape))
                    continue
                # cast to the template's dtype, as the reference does
                block[part[1]].copy_(member.read(shape)[part[0]])
        return out

    return S.read_pytree(S.step_path(directory, step), layout.whole, take, into=template)


def _write_host(directory: str, step: int, host: dict[str, np.ndarray]) -> None:
    tmp = _host_path(directory, step) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, _host_path(directory, step))


def save_checkpoint(directory: str, state: Any, pipeline: Any, step: int, *,
                    layout: StateLayout | None = None) -> None:
    """Write device state + host adaptation sidecar for ``step``.

    The host sidecar is written FIRST and the ``latest`` pointer last, so a
    crash mid-save can never leave ``latest`` naming a checkpoint whose
    sidecar is missing.  ``layout`` (``engine.checkpoint_layout()``): the
    state is one rank's of a multi-process run, and every rank calls this;
    rank 0 writes the one-process checkpoint (module docstring).  Without
    one, a rank of a multi-process run (a running sharded mesh, or any
    process group of more than one process) raises: every rank would write
    the same files.
    """
    import torch.distributed as dist

    from repro_torch.sharding.collectives import sharded_mesh

    if layout is None and (sharded_mesh() is not None or (
            dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1)):
        raise ValueError("the state is one rank's of a multi-process run: save it with "
                         "layout=engine.checkpoint_layout()")
    os.makedirs(directory, exist_ok=True)
    host = _host_state(pipeline)
    if layout is not None:
        _save_sharded(directory, state, step, layout, host)
        return
    _write_host(directory, step, host)
    save_train_state(directory, state, step)


def restore_checkpoint(
    directory: str, template_state: Any, pipeline: Any, *, step: int | None = None,
    device: Any = None, layout: StateLayout | None = None,
) -> tuple[Any, int]:
    """Restore ``(state, step)`` and re-arm the pipeline's host state.

    ``template_state`` is an engine-built state (or shape-only template, with
    its tensors on ``meta``; they are restored onto ``device``) with the
    layout the checkpoint was saved from (same mode, same ``fuse=``);
    structure mismatch raises with the offending key paths.  With a
    ``layout`` (``engine.checkpoint_layout()``) the template is one rank's,
    and every rank restores its own blocks of the one-process checkpoint,
    whatever layout saved it.  The pipeline is mutated in place: its
    estimator gets the saved counts/n_seen back, its staleness link the
    saved schedule table — so the next refresh boundary refits from exactly
    the observations the interrupted run had.
    """
    if layout is None:
        state, step = load_train_state(directory, template_state, step, device=device)
    else:
        step = S.latest_step(directory) if step is None else step
        state = _restore_sharded(directory, template_state, step, layout, device)
    host_path = _host_path(directory, step)
    link = refresh_link_of(pipeline)
    est = getattr(link, "estimator", None) if link is not None else None
    if not os.path.exists(host_path):
        # device state only: resuming an adaptive run from it would silently
        # restart the estimator — refuse loudly
        if est is not None:
            raise ValueError(
                f"checkpoint {directory!r} step {step} has no host sidecar but the "
                "pipeline carries an online estimator — it was not saved by "
                "save_checkpoint; resume cannot be bit-faithful")
        return state, step
    host = np.load(host_path)
    if link is not None and "schedule_table" in host.files:
        from repro_torch.core.step_size import StepSizeSchedule

        sched = getattr(link, "schedule", None)
        name = sched.name if sched is not None else "restored"
        # lenient on shape by design: a past refresh may have resized the host
        # table; the saved one is the truth the interrupted run was using
        link.schedule = StepSizeSchedule(table=np.asarray(host["schedule_table"]), name=name)
    if est is not None:
        if "est_counts" not in host.files:
            raise ValueError(
                f"checkpoint {directory!r} step {step}: pipeline has an estimator "
                "but the host sidecar saved none — was it saved from a different "
                "pipeline?")
        counts = np.asarray(host["est_counts"], np.float64)
        if counts.shape != est.counts.shape:
            raise ValueError(
                f"estimator support mismatch: checkpoint histogram {counts.shape} "
                f"!= estimator {est.counts.shape} (tau_max changed between save "
                "and resume)")
        est.counts = counts
        est.n_seen = int(host["est_n_seen"])
    return state, step
