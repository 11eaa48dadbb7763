"""Differentiable collectives of the sharded layers, and the one byte counter.

The reference lowers its sharded step through XLA's SPMD partitioner, which
inserts the collectives.  Eager PyTorch has none, so every sharded layer of
the port says where data crosses processes, with the helpers here, over the
process groups of a running :class:`~repro_torch.launch.mesh.Mesh`
(``use_sharding_rules(mesh)``):

* :func:`reduce_from_model`: the row-parallel output.  The partial sums of
  the ``model`` ranks are summed; the backward passes the cotangent through
  (every model rank holds the same loss, so each rank's cotangent is
  already the whole one);
* :func:`copy_to_model`: the column-parallel input.  The identity; the
  backward sums the cotangent over ``model`` (each rank's branch of the
  graph contributes its part);
* :func:`max_over_model`: a max over ``model`` with no gradient (the
  vocab-parallel softmax's shift);
* :func:`greedy_argmax`: the lowest global index of the largest logit of
  logits sharded over vocab, as one process's ``torch.argmax`` picks (an
  f32 max and an int64 min of ``(B,)``);
* :func:`gather_over_model`: the ranks' blocks of the last dim put side by
  side (the RG-LRU's conv output, whose gates read the whole width): each
  rank writes its block into a zero buffer of the whole width and the
  buffers are summed; the backward sums the cotangent over ``model`` and
  takes the rank's block (gloo gathers no CUDA tensor, and NCCL refuses
  two ranks on one card);

Whether a layer runs sharded is decided in one place, :func:`layout_mesh`,
from the port's storage layout
(:func:`~repro_torch.sharding.specs.storage_spec_for`): a leaf the layout
splits over ``model`` is held as the rank's block, a leaf whose dimension
``model`` does not divide is held whole.  The model's entry points check
that the params are the rank's blocks
(:func:`~repro_torch.sharding.specs.check_local_params`), so a tree held
whole raises there instead of running whole on every rank.
* :func:`sum_over_data`: the data-parallel sum (the loss, the token count,
  the gradient).

The expert-parallel MoE's general form, :func:`_sum_over` (a sum over one
group whose backward sums over another), lives here too.

A sharded checkpoint's collectives (:mod:`repro_torch.run.ckpt`) are here
as well, and are not counted: :func:`gather_to_writer` moves each chunk of
a leaf to the one process that writes the file, every element from the
one rank that owns it, as bits (point to point over gloo, as CPU tensors: no sum
turns ``-0.0`` into ``+0.0``, and no rank ever holds more than a chunk);
:func:`check_same_on_every_rank` holds the replicated leaves to one value.

Every all-reduce adds its buffer's bytes to :data:`COLLECTIVE_BYTES` under
its purpose (a measurement count: the size handed to the collective, never
waited for).  :func:`repro_torch.launch.analysis.port_collective_bytes`
plans the same counts from a config and a layout; the tests and
``chip_smoke.py`` hold one to the other exactly.

Nothing a step calls here waits for the device: no ``.item()``,
``float``/``int`` of a tensor or ``np.asarray`` (the checkpoint's gather
copies its chunks to the host).
"""

from __future__ import annotations

import torch

__all__ = [
    "COLLECTIVE_BYTES",
    "reset_collective_bytes",
    "sharded_mesh",
    "model_mesh",
    "layout_mesh",
    "vocab_mesh",
    "reduce_from_model",
    "copy_to_model",
    "max_over_model",
    "greedy_argmax",
    "gather_over_model",
    "sum_over_data",
    "sum_grads_over_data",
    "scale_grad",
    "local_rows",
    "make_sq_norm",
    "gather_to_writer",
    "check_same_on_every_rank",
]

# Bytes handed to all-reduce, by purpose.  The MoE's: "combine", "gather",
# "aux"; the dense layers': "embed" (the vocab-parallel lookup), "attn" and
# "mlp" (the row-parallel outputs; the shared expert's too), "logits" (the
# vocab-parallel cross-entropy's (B, S) reductions), "argmax" (the greedy
# pick); the recurrent layers': "ssm_proj" (the Mamba layer's row-parallel
# x_proj, the (dt, B, C) partial sums), "ssm_out" (its out_proj output),
# "lru_gather" (the RG-LRU's conv output gathered over model), "lru_out"
# (its out_proj output); the data-parallel ones: "loss" (token count and
# loss), "grad" (the flat gradient); "norm" (the clip link's squared
# norm); and "backward", every all-reduce of a backward pass.
COLLECTIVE_BYTES = {k: 0 for k in ("combine", "gather", "aux", "embed", "attn", "mlp", "logits",
                                   "argmax", "ssm_proj", "ssm_out", "lru_gather", "lru_out",
                                   "loss", "grad", "norm", "backward")}


def reset_collective_bytes() -> None:
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0


def _all_reduce(t: torch.Tensor, group, what: str, op=None) -> torch.Tensor:
    """Reduce contiguous ``t`` over the ranks of ``group`` (a sum unless
    ``op``), in place."""
    import torch.distributed as dist

    COLLECTIVE_BYTES[what] += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


class _SumOver(torch.autograd.Function):
    """Sum over ``group`` (None: the identity); the backward sums the
    cotangent over ``back`` (None: passes it through)."""

    @staticmethod
    def forward(ctx, t, group, back, what):
        ctx.back = back
        if group is None:
            return t.view_as(t)
        return _all_reduce(t.clone(memory_format=torch.contiguous_format), group, what)

    @staticmethod
    def backward(ctx, g):
        if ctx.back is not None:
            g = _all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.back,
                            "backward")
        return g, None, None, None


def _sum_over(t: torch.Tensor, group, what: str, back=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``; differentiated, the cotangent is
    summed over ``back``.  Without a gradient to carry the sum is in place."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _SumOver.apply(t, group, back, what)
    return _all_reduce(t.contiguous(), group, what)


def _to_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated input of a computation split over ``model``: the
    identity, whose backward sums the cotangent over ``model``."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _SumOver.apply(t, None, mesh.group("model"), "backward")
    return t


# ---------------------------------------------------------------------------
# The running layout
# ---------------------------------------------------------------------------

def sharded_mesh():
    """The mesh of the current sharding rules when its processes are running
    and there is more than one of them, else None."""
    from repro_torch.sharding.ctx import current_rules

    rules = current_rules()
    if rules is None or not getattr(rules.mesh, "running", False):
        return None
    mesh = rules.mesh
    return mesh if mesh.devices.size > 1 else None


def model_mesh():
    """:func:`sharded_mesh` when its ``model`` axis has more than one
    process (the layers shard), else None."""
    mesh = sharded_mesh()
    if mesh is None or "model" not in mesh.axis_names or mesh.shape["model"] == 1:
        return None
    return mesh


def layout_mesh(rule: str, whole: tuple[int, ...]):
    """:func:`model_mesh` when the port's storage layout splits a leaf
    named like ``rule`` (a path its rule matches) of the whole shape
    ``whole`` over ``model``, else None: the one decision of every
    sharded layer (module docstring)."""
    mesh = model_mesh()
    if mesh is None:
        return None
    from repro_torch.sharding.specs import storage_spec_for

    return mesh if "model" in storage_spec_for(rule, whole, mesh) else None


def vocab_mesh(cfg):
    """:func:`layout_mesh` of the embedding table: the running mesh when
    the embedding, the unembedding and the logits are split over vocab."""
    return layout_mesh("embedding", (cfg.vocab_size, cfg.d_model))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_size(mesh) -> int:
    axes = batch_axes(mesh)
    return mesh.size(axes) if axes else 1


def local_rows(batch: dict, mesh, *, strict: bool = True) -> dict:
    """This rank's rows of a global batch: every leaf's leading dim split
    over the batch axes (the reference's ``batch_specs``).  A leaf whose
    rows do not split raises, or with ``strict=False`` (serving) stays
    whole on every data rank, as the reference's spec replicates it."""
    n = data_size(mesh)
    if n == 1:
        return batch
    i = mesh.index(batch_axes(mesh))
    out = {}
    for k, t in batch.items():
        if t.shape[0] % n:
            if strict:
                raise ValueError(f"batch leaf {k!r} of {t.shape[0]} rows does not split over "
                                 f"{n} data ranks")
            out[k] = t
            continue
        rows = t.shape[0] // n
        out[k] = t[i * rows:(i + 1) * rows]
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism over `model`
# ---------------------------------------------------------------------------

def reduce_from_model(t: torch.Tensor, mesh, what: str) -> torch.Tensor:
    """The row-parallel output: summed over ``model``; the backward is the
    identity."""
    return _sum_over(t, mesh.group("model"), what)


def copy_to_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """The column-parallel input: the identity; the backward sums over
    ``model``."""
    return _to_model(t, mesh)


def max_over_model(t: torch.Tensor, mesh, what: str) -> torch.Tensor:
    """The elementwise max over ``model`` of a tensor that carries no
    gradient (a copy; ``t`` is left as it is)."""
    import torch.distributed as dist

    return _all_reduce(t.detach().clone(memory_format=torch.contiguous_format),
                       mesh.group("model"), what, op=dist.ReduceOp.MAX)


def greedy_argmax(logits: torch.Tensor, mesh) -> torch.Tensor:
    """``argmax`` over the last dim of the logits.  With ``mesh`` (the
    logits split over vocab, :func:`vocab_mesh`) each rank holds the vocab
    block ``[r V_loc, (r + 1) V_loc)``, and the pick is the lowest global
    index among the ranks whose local maximum is the global one, the index
    one process's ``torch.argmax`` returns (the first maximum)."""
    if mesh is None:
        return torch.argmax(logits, dim=-1)
    import torch.distributed as dist

    v_loc = logits.shape[-1]
    local_idx = torch.argmax(logits, dim=-1)
    # f32 holds every bf16 / f16 value exactly, so the comparison below is
    # the logits' own
    local_max = torch.gather(logits, -1, local_idx[..., None])[..., 0].to(torch.float32)
    top = max_over_model(local_max, mesh, "argmax")
    big = torch.iinfo(torch.int64).max
    cand = torch.where(local_max == top, local_idx + mesh.index("model") * v_loc, big)
    return _all_reduce(cand.contiguous(), mesh.group("model"), "argmax", op=dist.ReduceOp.MIN)


def _gather(t: torch.Tensor, group, n: int, index: int, what: str, dim: int = -1) -> torch.Tensor:
    """The blocks of the ``n`` ranks of ``group`` along ``dim``, side by side
    in ``index`` order, the same on every rank: each rank pads its block with
    zeros to the whole and the buffers are summed; the backward sums the
    cotangent over ``group`` and takes the rank's block (the pad's
    backward)."""
    dim %= t.dim()
    w = t.shape[dim]
    pad = [0, 0] * (t.dim() - 1 - dim) + [index * w, (n - 1 - index) * w]
    return _sum_over(torch.nn.functional.pad(t, pad), group, what, back=group)


def gather_over_model(t: torch.Tensor, mesh, what: str) -> torch.Tensor:
    """The ranks' blocks of ``t``'s last dim, side by side in rank order:
    ``(..., W / model)`` -> ``(..., W)`` (module docstring)."""
    return _gather(t, mesh.group("model"), mesh.shape["model"], mesh.index("model"), what)


# ---------------------------------------------------------------------------
# Data parallelism over `data`
# ---------------------------------------------------------------------------

def sum_over_data(t: torch.Tensor, mesh, what: str) -> torch.Tensor:
    """The sum over the batch axes; the backward is the identity (each data
    rank differentiates its own share, and the caller sums the gradients
    over ``data``, as data-parallel training does)."""
    return _sum_over(t, mesh.group(batch_axes(mesh)), what)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def scale_grad(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t`` itself, its cotangent multiplied by ``s``."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _ScaleGrad.apply(t, s)
    return t


def sum_grads_over_data(grads, mesh):
    """The data-parallel gradient sum, in place: a flat buffer in one
    all-reduce, a tree leaf by leaf."""
    from repro_torch.tree import tree_leaves

    group = mesh.group(batch_axes(mesh))
    for g in ([grads] if isinstance(grads, torch.Tensor) else tree_leaves(grads)):
        _all_reduce(g, group, "grad")
    return grads


def make_sq_norm(sizes: list[int], replicated: list[bool], mesh):
    """The squared global norm of a gradient held as this rank's blocks
    (a flat buffer of leaves of ``sizes``, or a tree in the same leaf
    order): the squares of the leaves split over ``model`` are summed over
    ``model``, those of the replicated leaves counted once, and nothing is
    summed over ``data`` (the gradient is already the same there)."""
    from repro_torch.tree import tree_leaves

    def sq_norm(u) -> torch.Tensor:
        parts = torch.split(u, sizes) if isinstance(u, torch.Tensor) else tree_leaves(u)
        split = torch.zeros((1,), dtype=torch.float32, device=parts[0].device)
        whole = torch.zeros((1,), dtype=torch.float32, device=parts[0].device)
        for part, rep in zip(parts, replicated):
            sq = torch.sum(torch.square(part.to(torch.float32)))
            if rep:
                whole = whole + sq
            else:
                split = split + sq
        return (reduce_from_model(split, mesh, "norm") + whole)[0]

    return sq_norm


# ---------------------------------------------------------------------------
# A sharded checkpoint's gather (uncounted)
# ---------------------------------------------------------------------------

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
WRITER = 0  # the one rank that writes a sharded checkpoint


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as integers of its width: copies of it keep every bit."""
    return t.view(_BITS[t.element_size()])


def gather_to_writer(pieces, rank: int, group=None):
    """Each chunk of a leaf, whole, on global rank :data:`WRITER`; None on
    every other rank.  ``pieces`` yields ``(shape, dtype, parts, mine)`` per
    chunk, the same sequence on every rank: ``parts`` the ``(rank,
    in_chunk)`` of every rank that writes part of the chunk (in rank order;
    they tile it), and ``mine`` this rank's part (on any device) when it is
    one of them.  Each part moves once, from its rank to the writer, as a
    CPU tensor of its bits over ``group`` (every rank's; gloo, which sends
    CPU tensors); nothing is summed and nothing is counted in
    :data:`COLLECTIVE_BYTES`.  Every rank calls it and consumes it in step."""
    import torch.distributed as dist

    for shape, dtype, parts, mine in pieces:
        if rank != WRITER:
            if mine is not None:
                dist.send(_bits(mine).contiguous().cpu(), WRITER, group=group)
            yield None
            continue
        chunk = torch.empty(shape, dtype=dtype)
        into, filled = _bits(chunk), 0
        for r, at in parts:
            if r == rank:
                into[at].copy_(_bits(mine))
            else:
                part = torch.empty(into[at].shape, dtype=into.dtype)
                dist.recv(part, r, group=group)
                into[at].copy_(part)
            filled += into[at].numel()
        if filled != chunk.numel():
            raise AssertionError(f"the ranks' parts cover {filled} of a chunk's "
                                 f"{chunk.numel()} elements")
        yield chunk


def check_same_on_every_rank(digests: dict, group=None) -> None:
    """Raise on every rank, naming the first key whose digest differs
    between the ranks of ``group`` (an object gather: not counted)."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, digests, group=group)
    for key in digests:
        ranks = [r for r, d in enumerate(got) if d[key] != got[0][key]]
        if ranks:
            raise ValueError(f"leaf {key}: ranks {ranks} hold other values than rank 0; a "
                             "replicated leaf must be the same on every rank to be saved once")
