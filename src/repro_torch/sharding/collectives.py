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
* :func:`max_over`: a max over ``model`` (or any of the layout's axes)
  with no gradient (the vocab-parallel softmax's shift);
* :func:`greedy_argmax`: the lowest global index of the largest logit of
  logits sharded over vocab, as one process's ``torch.argmax`` picks (an
  f32 max and an int64 min of ``(B,)``);
* :func:`gather_over_model`: the ranks' blocks of the last dim put side by
  side (the RG-LRU's conv output, whose gates read the whole width; a
  decode step's query heads under ``seq_shard_cache``): each
  rank writes its block into a zero buffer of the whole width and the
  buffers are summed; the backward sums the cotangent over ``model`` and
  takes the rank's block (gloo gathers no CUDA tensor, and NCCL refuses
  two ranks on one card);
* :func:`sum_over`: a sum over any of the layout's axes (with
  :func:`max_over`, a decode step's partial softmax combined over the axes
  its cache's capacity is split over, :func:`serving`);

Whether a layer runs sharded is decided in one place, :func:`layout_mesh`,
from the port's storage layout
(:func:`~repro_torch.sharding.specs.storage_spec_for`): a leaf the layout
splits over ``model`` is held as the rank's block, a leaf whose dimension
``model`` does not divide is held whole.  The model's entry points check
that the params are the rank's blocks
(:func:`~repro_torch.sharding.specs.check_local_params`), so a tree held
whole raises there instead of running whole on every rank.
* :func:`sum_over_data`: the data-parallel sum (the loss, the token count,
  the gradient of the leaves replicated over ``data``);
* :func:`gather_weights`: the FSDP gather.  A rank stores its block of every
  weight over ``data`` (the reference's ``param_spec_for``), and a layer's
  weights are gathered over the batch axes just before it runs
  (``dist.all_gather_into_tensor`` of the blocks, put side by side along
  the dim :func:`~repro_torch.sharding.specs.gather_dim` names: no sum, so
  every bit moves as it is); the backward reduce-scatters the cotangent
  over the batch axes (``dist.reduce_scatter_tensor``), so the gradient
  arrives as the rank's block, already summed over ``data``.

* :func:`seq_mesh`, :func:`gather_seq`, :func:`scatter_seq`: Megatron
  sequence parallelism (``cfg.sequence_parallel``, the reference's
  ``seq_sp`` rule).  Between the blocks the residual stream is the rank's
  chunk of the sequence; :func:`enter_linear` gathers a layer's input over
  ``model`` along the sequence (``dist.all_gather_into_tensor``; the
  backward reduce-scatters the cotangent, or takes the rank's chunk of it
  for a layer held whole) and, as Megatron does, keeps only the chunk for
  the backward, which gathers it again for the weights' gradients (the
  column-parallel products are computed in the same autograd function);
  :func:`leave_model` reduce-scatters its
  row-parallel output to the chunks (``dist.reduce_scatter_tensor``, in
  place of :func:`reduce_from_model`'s all-reduce; the backward gathers the
  chunks' cotangents).

The expert-parallel MoE's general form, :func:`_sum_over` (a sum over one
group whose backward sums over another), lives here too.

A sharded checkpoint's collectives (:mod:`repro_torch.run.ckpt`) are here
as well, and are not counted: :func:`gather_to_writer` moves each chunk of
a leaf to the one process that writes the file, every element from the
one rank that owns it, as bits (point to point over gloo, as CPU tensors: no sum
turns ``-0.0`` into ``+0.0``, and no rank ever holds more than a chunk);
:func:`check_same_on_every_rank` holds the replicated leaves to one value.

Every all-reduce, all-gather and reduce-scatter adds the bytes of its whole
buffer (the gathered one, the one scattered) to :data:`COLLECTIVE_BYTES` under
its purpose (a measurement count: the size handed to the collective, never
waited for).  :func:`repro_torch.launch.analysis.port_collective_bytes`
plans the same counts from a config and a layout; the tests and
``chip_smoke.py`` hold one to the other exactly.

Nothing a step calls here waits for the device: no ``.item()``,
``float``/``int`` of a tensor or ``np.asarray`` (the checkpoint's gather
copies its chunks to the host).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

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
    "greedy_argmax",
    "gather_over_model",
    "max_over",
    "sum_over",
    "ServeShape",
    "serving",
    "serve_shape",
    "sum_over_data",
    "gather_weights",
    "seq_mesh",
    "gather_seq",
    "scatter_seq",
    "enter_linear",
    "leave_model",
    "data_layout",
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
# loss), "grad" (the gradient of the leaves replicated over data); the
# FSDP ones: "fsdp_gather" (a weight gathered over data, the bytes of the
# gathered leaf) and "fsdp_grad" (its gradient reduce-scattered, the same
# bytes); "norm" (the clip link's squared norm); "backward", every
# other all-reduce of a backward pass; and the sequence-parallel ones (bytes
# handed to all-gather and to reduce-scatter, not to all-reduce, in the
# forward and the backward alike): "sp_gather" (a chunked sequence gathered
# over model, the bytes of the gathered buffer) and "sp_scatter" (a
# sequence reduce-scattered to the chunks, the bytes of the whole buffer);
# and a decode step's over a cache whose capacity is split
# (``SPEC_OPTIONS["seq_shard_cache"]``): "kv_gather" (the query heads
# gathered over model) and "kv_combine" (the partial softmax's row maximum,
# and its sums and weighted values, reduced over the capacity's axes).
COLLECTIVE_BYTES = {k: 0 for k in ("combine", "gather", "aux", "embed", "attn", "mlp", "logits",
                                   "argmax", "ssm_proj", "ssm_out", "lru_gather", "lru_out",
                                   "loss", "grad", "fsdp_gather", "fsdp_grad", "norm",
                                   "backward", "sp_gather", "sp_scatter", "kv_gather",
                                   "kv_combine")}


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


@dataclasses.dataclass(frozen=True)
class ServeShape:
    """What a rank's decode caches are laid out by beyond its own tensors
    (:func:`~repro_torch.sharding.specs.capacity_split` reads the whole
    leaf): ``batch`` the global batch, before :func:`local_rows` (batch 2 at
    data 2 leaves each rank one row, as batch 1 does, but only batch 1 keeps
    the same row on every data rank), ``capacity`` the positions a decode
    cache holds and ``memory`` whisper's encoder frames (its cross K/V's
    length; None for the other archs)."""

    batch: int
    capacity: int
    memory: int | None = None


_SERVE_SHAPE: contextvars.ContextVar[ServeShape | None] = contextvars.ContextVar(
    "serve_shape", default=None)


@contextlib.contextmanager
def serving(batch: int, capacity: int, memory: int | None = None):
    """The :class:`ServeShape` of the decode caches built and stepped inside
    (``launch/serve.py::serve`` sets it).  Needed only where
    ``SPEC_OPTIONS["seq_shard_cache"]`` may split a cache's capacity under a
    running sharded mesh: without it a rank cannot tell the whole leaf from
    its own block."""
    token = _SERVE_SHAPE.set(ServeShape(batch, capacity, memory))
    try:
        yield
    finally:
        _SERVE_SHAPE.reset(token)


def serve_shape() -> ServeShape | None:
    """The :class:`ServeShape` of :func:`serving` in force, or None."""
    return _SERVE_SHAPE.get()


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


def max_over(t: torch.Tensor, mesh, axes, what: str) -> torch.Tensor:
    """The elementwise max over ``axes`` of a tensor that carries no
    gradient (a copy; ``t`` is left as it is)."""
    import torch.distributed as dist

    return _all_reduce(t.detach().clone(memory_format=torch.contiguous_format),
                       mesh.group(axes), what, op=dist.ReduceOp.MAX)


def sum_over(t: torch.Tensor, mesh, axes, what: str) -> torch.Tensor:
    """The sum over ``axes``; the backward is the identity."""
    return _sum_over(t, mesh.group(axes), what)


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
    top = max_over(local_max, mesh, "model", "argmax")
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


def gather_over_model(t: torch.Tensor, mesh, what: str, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``t``'s dim ``dim`` (the last by default), side
    by side in rank order: ``(..., W / model)`` -> ``(..., W)`` (module
    docstring)."""
    return _gather(t, mesh.group("model"), mesh.shape["model"], mesh.index("model"), what,
                   dim=dim)


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


# ---------------------------------------------------------------------------
# FSDP storage over `data`
# ---------------------------------------------------------------------------

class DataLayout:
    """Where a config's param leaves sit over a layout, for the current
    ``SPEC_OPTIONS``, in the param tree's leaf order (the flat buffer's):
    ``shapes`` each leaf's block as a rank stores it, by path; ``sizes``
    their numels; ``axes`` the axes each leaf is split over (``()`` for a
    replicated one); ``whole`` whether a leaf is whole over the batch axes;
    ``dims`` the dim (from the end) each gathered leaf is gathered along,
    by path."""

    def __init__(self, cfg, mesh):
        from repro_torch.models import model as M
        from repro_torch.sharding.specs import (
            _axes_of,
            gather_dim,
            leaf_paths,
            local_shape,
            storage_spec_for,
        )

        daxes = batch_axes(mesh)
        self.shapes, self.axes, self.dims = {}, [], {}
        for path, leaf in leaf_paths(M.init_model(None, cfg, "meta")):
            shape = tuple(leaf.shape)
            spec = storage_spec_for(path, shape, mesh, cfg)
            dim = gather_dim(path, shape, mesh, cfg)
            if dim is not None:
                self.dims[path] = dim
            self.shapes[path] = tuple(local_shape(shape, spec, mesh))
            self.axes.append(tuple(a for a in mesh.axis_names
                                   if any(a in _axes_of(e) for e in spec)))
        self.sizes = [math.prod(s) for s in self.shapes.values()]
        self.whole = [not any(a in daxes for a in axes) for axes in self.axes]

    def whole_runs(self) -> list[tuple[int, int]]:
        """``(offset, length)`` of each run of leaves whole over the batch
        axes in the rank's flat buffer (every leaf, replicated over data)."""
        runs, start = [], 0
        for n, whole in zip(self.sizes, self.whole):
            if whole:
                if runs and sum(runs[-1]) == start:
                    runs[-1] = (runs[-1][0], runs[-1][1] + n)
                else:
                    runs.append((start, n))
            start += n
        return runs


def data_layout(cfg, mesh) -> DataLayout:
    """:class:`DataLayout` of ``cfg`` on ``mesh``, built once per config and
    layout option (kept on the mesh)."""
    from repro_torch.sharding.specs import SPEC_OPTIONS

    key = (cfg, SPEC_OPTIONS["replicate_params_over_data"])
    got = mesh.data_layouts.get(key)
    if got is None:
        got = mesh.data_layouts[key] = DataLayout(cfg, mesh)
    return got


def _all_gather(t: torch.Tensor, mesh, dim: int, what: str) -> torch.Tensor:
    """The blocks of ``t`` of the ranks of the batch axes, side by side along
    ``dim`` in their order (no sum: every bit as the ranks hold it)."""
    import torch.distributed as dist

    axes = batch_axes(mesh)
    n = mesh.size(axes)
    dim %= t.dim()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    COLLECTIVE_BYTES[what] += out.numel() * out.element_size()
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group(axes))
    if dim == 0:
        return out
    return out.unflatten(0, (n, t.shape[0])).movedim(0, dim).flatten(dim, dim + 1)


class _GatherOverData(torch.autograd.Function):
    """The FSDP gather of a leaf along ``dim``; the backward reduce-scatters
    the cotangent over the batch axes: the rank's block of its sum."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim % t.dim()
        return _all_gather(t, mesh, dim, "fsdp_gather")

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        mesh, dim = ctx.mesh, ctx.dim
        axes = batch_axes(mesh)
        g = g.movedim(dim, 0).contiguous()
        out = torch.empty((g.shape[0] // mesh.size(axes),) + tuple(g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        COLLECTIVE_BYTES["fsdp_grad"] += g.numel() * g.element_size()
        dist.reduce_scatter_tensor(out, g, group=mesh.group(axes))
        return out.movedim(0, dim), None, None


# ---------------------------------------------------------------------------
# Megatron sequence parallelism over `model`
# ---------------------------------------------------------------------------

def seq_mesh(cfg, seq: int):
    """:func:`model_mesh` when ``cfg.sequence_parallel`` holds the residual
    stream of a ``seq``-long sequence as the rank's ``seq / model`` chunk
    between the blocks (the reference's ``seq_sp`` rule), else None: with
    one ``model`` process, or where ``model`` does not divide ``seq`` (a
    decode step's 1 among them), the residual stays whole."""
    mesh = model_mesh()
    if not cfg.sequence_parallel or mesh is None or seq % mesh.shape["model"]:
        return None
    return mesh


def _seq_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' chunks of dim 1, side by side in ``model`` order (every
    bit as the ranks hold them)."""
    import torch.distributed as dist

    n = mesh.shape["model"]
    part = t.movedim(1, 0).contiguous()
    out = torch.empty((n * part.shape[0],) + tuple(part.shape[1:]), dtype=t.dtype,
                      device=t.device)
    COLLECTIVE_BYTES["sp_gather"] += out.numel() * out.element_size()
    dist.all_gather_into_tensor(out, part, group=mesh.group("model"))
    return out.movedim(0, 1)


def _seq_scatter(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's chunk of dim 1 of the sum over ``model``."""
    import torch.distributed as dist

    n = mesh.shape["model"]
    whole = t.movedim(1, 0).contiguous()
    out = torch.empty((whole.shape[0] // n,) + tuple(whole.shape[1:]), dtype=t.dtype,
                      device=t.device)
    COLLECTIVE_BYTES["sp_scatter"] += whole.numel() * whole.element_size()
    dist.reduce_scatter_tensor(out, whole, group=mesh.group("model"))
    return out.movedim(0, 1)


def _seq_chunk(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's chunk of dim 1 (no communication)."""
    n = t.shape[1] // mesh.shape["model"]
    return t.narrow(1, mesh.index("model") * n, n)


class _GatherSeq(torch.autograd.Function):
    """The chunks of the sequence gathered over ``model``; the backward
    reduce-scatters the cotangent (``summed``: the layer after the gather
    is split over ``model``, each rank's cotangent a partial sum) or takes
    the rank's chunk of it (the layer runs whole on every rank, whose
    cotangents are the same)."""

    @staticmethod
    def forward(ctx, t, mesh, summed):
        ctx.mesh, ctx.summed = mesh, summed
        return _seq_gather(t, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return _seq_scatter(g, ctx.mesh), None, None
        return _seq_chunk(g, ctx.mesh), None, None


class _ScatterSeq(torch.autograd.Function):
    """The rank's chunk of the sequence of a sum over ``model`` (``summed``:
    the row-parallel output) or of a tensor every rank holds whole; the
    backward gathers the chunks' cotangents over ``model``."""

    @staticmethod
    def forward(ctx, t, mesh, summed):
        ctx.mesh = mesh
        if summed:
            return _seq_scatter(t, mesh)
        return _seq_chunk(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return _seq_gather(g, ctx.mesh), None, None


def gather_seq(t: torch.Tensor, mesh, *, summed: bool) -> torch.Tensor:
    """``(B, S / model, ...)`` -> ``(B, S, ...)``: the sequence gathered over
    ``model`` (:class:`_GatherSeq`); the identity with no ``mesh``."""
    if mesh is None:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherSeq.apply(t, mesh, summed)
    return _seq_gather(t, mesh)


def scatter_seq(t: torch.Tensor, mesh, *, summed: bool) -> torch.Tensor:
    """``(B, S, ...)`` -> the rank's ``(B, S / model, ...)`` chunk: of the
    sum over ``model`` (a reduce-scatter) when ``summed``, else of ``t``
    itself (:class:`_ScatterSeq`); the identity with no ``mesh``."""
    if mesh is None:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _ScatterSeq.apply(t, mesh, summed)
    return _seq_scatter(t, mesh) if summed else _seq_chunk(t, mesh)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (..., D) against a column-parallel weight: ``x @ w`` for a
    (D, F) matrix, the heads' product for a (D, N, H) stack."""
    return x @ w if w.dim() == 2 else torch.einsum("bsd,dnh->bsnh", x, w)


class _GatherLinear(torch.autograd.Function):
    """Megatron's sequence-parallel column-parallel input: the chunks of
    the sequence gathered over ``model`` and projected by each weight
    (:func:`_proj`, in the weight's dtype) -> (the gathered input, *the
    products).  Only the chunk is kept for the backward, which gathers it
    again for the weights' gradients; the input's cotangent (the gathered
    input's and each product's) is reduce-scattered (``summed``) or cut to
    the rank's chunk (a layer held whole), as :class:`_GatherSeq`'s."""

    @staticmethod
    def forward(ctx, t, mesh, summed, *ws):
        ctx.mesh, ctx.summed = mesh, summed
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(t, *ws)
        xg = _seq_gather(t, mesh)
        return (xg,) + tuple(_proj(xg.to(w.dtype), w) for w in ws)

    @staticmethod
    def backward(ctx, g_x, *g_out):
        t, *ws = ctx.saved_tensors
        xg = _seq_gather(t, ctx.mesh)
        dx, dws = g_x, []
        for w, g in zip(ws, g_out):
            if g is None:
                dws.append(None)
                continue
            w2 = w.reshape(w.shape[0], -1)
            g2 = g.reshape(-1, w2.shape[1])
            dws.append((xg.reshape(-1, w2.shape[0]).to(w.dtype).t() @ g2).reshape(w.shape))
            d = (g2 @ w2.t()).reshape(xg.shape).to(xg.dtype)
            dx = d if dx is None else dx + d
        dx = _seq_scatter(dx, ctx.mesh) if ctx.summed else _seq_chunk(dx, ctx.mesh)
        return (dx, None, None) + tuple(dws)


def enter_linear(t: torch.Tensor, mesh, seq, ws=()) -> tuple:
    """A layer's input and its column-parallel products -> ``(input,
    *[input @ w for w in ws])`` (:func:`_proj`, each in ``w``'s dtype).
    With ``seq`` (:func:`seq_mesh`; ``t`` is the rank's chunk of the
    sequence) the input is gathered over ``model``, its cotangent
    reduce-scattered when ``mesh`` splits the layer (else cut to the
    chunk), and under autograd only the chunk is kept for the backward,
    which gathers it again (:class:`_GatherLinear`); else with ``mesh``
    (the layer split over ``model``) the input is the column-parallel
    :func:`copy_to_model`, else ``t``."""
    if seq is not None and ws and torch.is_grad_enabled() and (
            t.requires_grad or any(w.requires_grad for w in ws)):
        return _GatherLinear.apply(t, seq, mesh is not None, *ws)
    if seq is not None:
        x = gather_seq(t, seq, summed=mesh is not None)
    else:
        x = t if mesh is None else copy_to_model(t, mesh)
    return (x,) + tuple(_proj(x.to(w.dtype), w) for w in ws)


def leave_model(t: torch.Tensor, mesh, what: str, seq) -> torch.Tensor:
    """A layer's output: with ``seq`` the rank's chunk of the sequence (of
    the sum over ``model`` when ``mesh`` splits the layer, a reduce-scatter
    in place of the all-reduce), else with ``mesh`` the row-parallel sum
    (:func:`reduce_from_model`, counted under ``what``), else ``t``."""
    if seq is not None:
        return scatter_seq(t, seq, summed=mesh is not None)
    return t if mesh is None else reduce_from_model(t, mesh, what)


def gather_weights(tree, prefix: str, cfg):
    """``tree`` (the param subtree at ``prefix``: one layer's, or the
    embedding's) with every leaf the storage layout splits over ``data``
    gathered over the batch axes, as a layer reads it: its block over
    ``model`` alone (module docstring).  The identity with no running
    mesh, one data rank or ``replicate_params_over_data``.  Differentiated,
    each gathered leaf's gradient is the rank's block of the sum over
    ``data``."""
    mesh = sharded_mesh()
    if mesh is None or data_size(mesh) == 1:
        return tree
    dims = data_layout(cfg, mesh).dims
    if not dims:
        return tree
    from repro_torch.sharding.specs import _map_with_path

    def one(path, t):
        dim = dims.get(path)
        if dim is None:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _GatherOverData.apply(t, mesh, dim)
        return _all_gather(t, mesh, dim, "fsdp_gather")

    return _map_with_path(one, tree, prefix)


def sum_grads_over_data(grads, mesh, cfg):
    """The data-parallel gradient sum of the leaves the storage layout keeps
    whole over ``data``, in place (the leaves split over ``data`` come out
    of :func:`gather_weights`' backward summed): a flat buffer in one
    all-reduce per run of such leaves, a tree leaf by leaf."""
    from repro_torch.tree import tree_leaves

    layout = data_layout(cfg, mesh)
    group = mesh.group(batch_axes(mesh))
    if isinstance(grads, torch.Tensor):
        parts = [grads.narrow(0, a, n) for a, n in layout.whole_runs()]
    else:
        parts = [g for g, whole in zip(tree_leaves(grads), layout.whole) if whole]
    for g in parts:
        _all_reduce(g, group, "grad")
    return grads


def make_sq_norm(cfg, mesh):
    """The squared global norm of a gradient held as this rank's blocks
    (a flat buffer packed from the rank's blocks, or a tree in the same
    leaf order): each leaf's square summed over the axes the storage
    layout splits it over (:class:`DataLayout`), a replicated leaf's
    counted once."""
    from repro_torch.tree import tree_leaves

    layout = data_layout(cfg, mesh)
    kinds = sorted(set(layout.axes), key=lambda axes: (len(axes), axes))

    def sq_norm(u) -> torch.Tensor:
        parts = torch.split(u, layout.sizes) if isinstance(u, torch.Tensor) else tree_leaves(u)
        sums = {axes: torch.zeros((1,), dtype=torch.float32, device=parts[0].device)
                for axes in kinds}
        for part, axes in zip(parts, layout.axes):
            sums[axes] = sums[axes] + torch.sum(torch.square(part.to(torch.float32)))
        total = None
        for axes in kinds:
            if axes:
                s = _sum_over(sums[axes], mesh.group(axes), "norm")
                total = s if total is None else total + s
        whole = sums.get(())
        if whole is not None:
            total = whole if total is None else total + whole
        return total[0]

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
