"""Checkpointing: tree <-> (npz arrays + json manifest); port of
``src/repro/checkpoint/store.py`` with the same on-disk format.

Array names in the npz are the reference's **key paths**: a dataclass field
is ``.field``, a dict key ``['k']`` (sorted), a tuple or list index ``[i]``,
and ``None`` has no leaf — e.g. ``.params['embed']['embedding']``,
``.delayed.ring``, ``.opt_state['bufs']``.  So a checkpoint is introspectable
with nothing but ``np.load``, a restore can validate *structure* (missing or
unexpected paths raise a :class:`ValueError` naming them), and trees of
tensors cross between the two packages in both directions.

The json manifest (``ckpt.v2``) lists the keys; ``dtypes`` names leaves
stored as same-width unsigned views (bf16 as ``uint16`` under
``"bfloat16"``), and ``generators`` names leaves that hold a
``torch.Generator``'s state (``uint8``, the port's ``.rng``) with the
generator's device type.  A jax PRNG key is not a generator state, so a
TrainState's ``.rng`` cannot cross packages: restoring one raises.

Writes are streamed one leaf at a time, in chunks (:func:`runs`), so the
host never holds more than a chunk of a device leaf: :func:`write_pytree`
takes each leaf as a :class:`LeafStream` of chunks, from wherever they come
(a leaf held whole, or the ranks of a sharded state,
:mod:`repro_torch.run.ckpt`).  A restore allocates each leaf once on its
target device and copies the file into it chunk by chunk; :func:`read_pytree`
hands each leaf's :class:`Member` to a slicer that reads the chunks it keeps
and skips the rest.  Files go to ``*.tmp`` first and are moved into place
with ``os.replace``.
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import zipfile
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

__all__ = [
    "save_pytree",
    "load_pytree",
    "write_pytree",
    "read_pytree",
    "LeafStream",
    "Member",
    "runs",
    "run_shape",
    "step_path",
    "set_latest",
    "save_train_state",
    "load_train_state",
    "latest_step",
    "key_paths",
]

SCHEMA = "ckpt.v2"
CHUNK_BYTES = 1 << 28
# extension dtypes (bf16, f8) by width: the torch view that holds their bits,
# and the numpy dtype they are stored as
_UINT = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16)}
_NP_OF = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
          torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
          torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}
_TORCH_OF = {np.dtype(n): t for t, n in _NP_OF.items()}


def key_paths(tree: Any, prefix: str = "", stop: Callable[[Any], bool] | None = None
              ) -> Iterator[tuple[str, Any]]:
    """``(name, leaf)`` pairs in the reference's flatten order and names.
    ``stop``: a node it holds true of is yielded whole, as a leaf."""
    if tree is None:
        return
    if stop is not None and stop(tree):
        yield prefix, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from key_paths(getattr(tree, f.name), f"{prefix}.{f.name}", stop)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from key_paths(tree[k], f"{prefix}[{k!r}]", stop)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from key_paths(v, f"{prefix}[{i}]", stop)
    else:
        yield prefix, tree


def _rebuild(tree: Any, leaves: Iterator) -> Any:
    """``tree`` with its leaves replaced, in :func:`key_paths` order."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                     for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _np_dtype(dtype: torch.dtype) -> tuple[np.dtype, str | None]:
    """The numpy dtype a leaf of ``dtype`` is stored as, and its
    extension-dtype name (bf16 / f8, whose bits numpy holds as a uint view)."""
    if dtype in _NP_OF:
        return np.dtype(_NP_OF[dtype]), None
    return np.dtype(_UINT[dtype.itemsize][1]), str(dtype).split(".")[-1]


def runs(shape: tuple[int, ...], itemsize: int) -> Iterator[tuple[tuple[int, ...], int, int]]:
    """The chunks a leaf of ``shape`` is streamed in, in row-major order:
    ``(index, lo, hi)`` is the elements ``[*index, lo:hi, ...]``, at most
    :data:`CHUNK_BYTES` each (one element at least).  ``index`` fixes the
    leading dims, ``lo:hi`` runs along the next one, and the dims after it
    are whole.  A 0-d leaf is one run, ``((), 0, 1)``."""
    if not shape:
        yield (), 0, 1
        return
    inner, d = itemsize, len(shape) - 1
    while d > 0 and inner * shape[d] <= CHUNK_BYTES:
        inner *= shape[d]
        d -= 1
    per = max(CHUNK_BYTES // inner, 1)
    for index in itertools.product(*(range(n) for n in shape[:d])):
        for lo in range(0, shape[d], per):
            yield index, lo, min(lo + per, shape[d])


def run_shape(shape: tuple[int, ...], run) -> tuple[int, ...]:
    """The shape of one of :func:`runs`' chunks of a leaf of ``shape``."""
    index, lo, hi = run
    return (hi - lo,) + tuple(shape[len(index) + 1:]) if shape else ()


@dataclasses.dataclass
class LeafStream:
    """One leaf as the writer streams it: its name, whole shape and dtype, and
    its bytes as CPU tensors of ``dtype`` in row-major order (any cut).  A
    generator leaf is its state (``uint8``) and names its device type."""

    key: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    chunks: Iterable[torch.Tensor]
    generator: str | None = None


def _stream_of(key: str, leaf) -> LeafStream:
    """The :class:`LeafStream` of a leaf held whole by this process."""
    t = leaf.get_state() if isinstance(leaf, torch.Generator) else torch.as_tensor(leaf).detach()
    shape, itemsize = tuple(t.shape), t.element_size()
    chunks = (t[index][lo:hi] if shape else t for index, lo, hi in runs(shape, itemsize))
    gen = leaf.device.type if isinstance(leaf, torch.Generator) else None
    return LeafStream(key, shape, t.dtype, (c.cpu() for c in chunks), gen)


def _write_leaf(zf: zipfile.ZipFile, leaf: LeafStream) -> str | None:
    np_dtype, ext = _np_dtype(leaf.dtype)
    header = {"descr": np.lib.format.dtype_to_descr(np_dtype), "fortran_order": False,
              "shape": leaf.shape}
    with zf.open(leaf.key + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array_header_1_0(f, header)
        for chunk in leaf.chunks:
            chunk = chunk.contiguous().reshape(-1)
            if ext:
                chunk = chunk.view(_UINT[chunk.element_size()][0])
            f.write(chunk.numpy().view(np_dtype).data)
    return ext


def write_pytree(path: str, leaves: Iterable[LeafStream]) -> None:
    """Write ``path``.npz (key-path-named arrays, each streamed from its
    chunks) + ``path``.json (manifest)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys, ext_dtypes, generators = [], {}, {}
    tmp = path + ".npz.tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for leaf in leaves:
            ext = _write_leaf(zf, leaf)
            if ext is not None:
                ext_dtypes[leaf.key] = ext
            if leaf.generator is not None:
                generators[leaf.key] = leaf.generator
            keys.append(leaf.key)
    # write-to-tmp + atomic replace: RE-saving an existing step must never
    # leave a torn npz/json behind an intact 'latest' pointer
    os.replace(tmp, path + ".npz")
    tmp = path + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump({"schema": SCHEMA, "keys": keys, "num_leaves": len(keys),
                   "dtypes": ext_dtypes, "generators": generators}, f, indent=2)
    os.replace(tmp, path + ".json")


def save_pytree(path: str, tree: Any) -> None:
    """Write ``path``.npz (key-path-named arrays) + ``path``.json (manifest)."""
    write_pytree(path, (_stream_of(key, leaf) for key, leaf in key_paths(tree)))


def _read_header(f) -> tuple[tuple, np.dtype]:
    version = np.lib.format.read_magic(f)
    read = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}[version]
    shape, fortran, dtype = read(f)
    if fortran and len(shape) > 1:
        raise ValueError("Fortran-ordered arrays are not checkpoint leaves")
    return tuple(shape), dtype


class Member:
    """One leaf of an open checkpoint, read front to back: :meth:`read`
    hands over the next elements as a CPU tensor of the stored dtype,
    :meth:`skip` passes over elements this reader does not keep (a seek:
    members are stored uncompressed)."""

    def __init__(self, f, key: str, shape: tuple[int, ...], np_dtype: np.dtype,
                 stored: torch.dtype):
        self.f, self.key, self.shape, self.np_dtype, self.stored = f, key, shape, np_dtype, stored

    def read(self, shape: tuple[int, ...]) -> torch.Tensor:
        n = math.prod(shape)
        raw = self.f.read(n * self.np_dtype.itemsize)
        if len(raw) != n * self.np_dtype.itemsize:
            raise ValueError(f"leaf {self.key}: checkpoint array is truncated")
        src = np.frombuffer(raw, dtype=self.np_dtype)
        if src.dtype.kind == "u" and src.dtype.itemsize > 1:
            src = src.view(src.dtype.str.replace("u", "i"))
        return torch.from_numpy(src.copy()).view(self.stored).reshape(shape)

    def skip(self, n: int) -> None:
        if n:
            self.f.seek(n * self.np_dtype.itemsize, os.SEEK_CUR)


def _read_manifest(path: str) -> dict:
    try:
        with open(path + ".json") as f:
            return json.load(f)
    except FileNotFoundError:
        # save_pytree always writes the manifest (npz first, json second); a
        # missing one means an interrupted or hand-pruned save.  Defaulting to
        # "no extension dtypes" would silently value-cast uint views of bf16
        # leaves into garbage weights — refuse instead.
        raise FileNotFoundError(
            f"checkpoint manifest {path + '.json'!r} is missing (incomplete "
            "save?) — cannot restore without it; extension-dtype leaves "
            "(bf16/f8) are stored as uint views whose true dtype lives in "
            "the manifest"
        ) from None


def _check_structure(path: str, zf: zipfile.ZipFile, keys: list[str]) -> None:
    files = [n[: -len(".npy")] if n.endswith(".npy") else n for n in zf.namelist()]
    keyset, fileset = set(keys), set(files)
    missing = [k for k in keys if k not in fileset]
    extra = [k for k in files if k not in keyset]
    if missing or extra:
        lines = [f"checkpoint {path!r} does not match the restore template:"]
        if missing:
            lines.append(
                f"  template paths absent from the checkpoint ({len(missing)}): "
                + ", ".join(missing[:8]) + (" ..." if len(missing) > 8 else ""))
        if extra:
            lines.append(
                f"  checkpoint paths absent from the template ({len(extra)}): "
                + ", ".join(extra[:8]) + (" ..." if len(extra) > 8 else ""))
        lines.append(
            "  (restore into the state the checkpoint was saved from — same "
            "engine mode, same fuse= layout, same pipeline)")
        raise ValueError("\n".join(lines))


def _open_member(zf, path: str, key: str, ref, manifest: dict):
    """The member of ``key``, checked against the template leaf ``ref``: a
    generator's state for a generator (of its device type), a tensor of the
    template's shape otherwise."""
    gens = manifest.get("generators", {})
    f = zf.open(key + ".npy")
    shape, np_dtype = _read_header(f)
    if isinstance(ref, torch.Generator):
        if key not in gens:
            raise ValueError(
                f"leaf {key}: checkpoint {path!r} holds a {np_dtype} array of shape "
                f"{shape} there, not a torch.Generator state (a jax PRNG key from the "
                "reference?) — generator state cannot cross packages")
        if gens[key] != ref.device.type:
            raise ValueError(f"leaf {key}: a {gens[key]} generator's state cannot "
                             f"restore a {ref.device.type} generator")
        return Member(f, key, shape, np_dtype, torch.uint8)
    if key in gens:
        raise ValueError(f"leaf {key}: checkpoint holds a generator state, "
                         "the template a tensor")
    ref_shape = tuple(ref.shape)
    if shape != ref_shape:
        raise ValueError(f"leaf {key}: checkpoint shape {shape} != expected {ref_shape}")
    ext = manifest.get("dtypes", {}).get(key)
    stored = getattr(torch, ext) if ext else _TORCH_OF.get(np_dtype)
    if stored is None:
        raise ValueError(f"leaf {key}: unsupported stored dtype {np_dtype}")
    return Member(f, key, shape, np_dtype, stored)


def read_pytree(path: str, like: Any, take: Callable[[str, Any, Member], Any], *,
                into: Any = None) -> Any:
    """Restore into the structure of ``like``, whose leaves are the ones the
    checkpoint holds (the one-process tree, or its shape-only template).

    Structure is validated key path by key path: a checkpoint whose leaves do
    not exactly cover the template's raises a :class:`ValueError` naming the
    missing/unexpected paths; a leaf of another shape raises naming it.
    ``take(key, ref, member)`` reads each leaf's member (in order, any part
    of it) and returns what the restored tree holds there, a tree of the
    structure of ``into`` (default ``like``)."""
    manifest = _read_manifest(path)
    pairs = list(key_paths(like))
    leaves = []
    with zipfile.ZipFile(path + ".npz") as zf:
        _check_structure(path, zf, [k for k, _ in pairs])
        for key, ref in pairs:
            member = _open_member(zf, path, key, ref, manifest)
            with member.f:
                leaves.append(take(key, ref, member))
    return _rebuild(like if into is None else into, iter(leaves))


def restore_generator(ref: torch.Generator, member: Member) -> torch.Generator:
    gen = torch.Generator(device=ref.device)
    gen.set_state(member.read(member.shape))
    return gen


def load_pytree(path: str, like: Any, *, device: Any = None) -> Any:
    """Restore into the structure of ``like``.

    Structure is validated key path by key path: a checkpoint whose leaves do
    not exactly cover the template's raises a :class:`ValueError` naming the
    missing/unexpected paths.  Per-leaf shapes are then checked and dtypes
    cast to the template's.  Each leaf lands on its template leaf's device;
    a ``meta`` template leaf (a shape-only template) lands on ``device``.
    """

    def take(key, ref, member):
        if isinstance(ref, torch.Generator):
            return restore_generator(ref, member)
        target = ref.device if ref.device.type != "meta" else torch.device(device)
        out = torch.empty(member.shape, dtype=ref.dtype, device=target)
        for index, lo, hi in runs(member.shape, member.np_dtype.itemsize):
            chunk = member.read(run_shape(member.shape, (index, lo, hi)))
            # cast to the template's dtype, as the reference does
            (out[index][lo:hi] if member.shape else out).copy_(chunk)
        return out

    return read_pytree(path, like, take)


def step_path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def save_train_state(path: str, state: Any, step: int) -> None:
    save_pytree(step_path(path, step), state)
    set_latest(path, step)


def set_latest(path: str, step: int) -> None:
    """Point ``latest`` at ``step``: the last act of a save."""
    # atomic pointer swap: a crash mid-update must never leave a truncated
    # 'latest' (that would brick resume even with complete checkpoints on disk)
    tmp = os.path.join(path, "latest.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(path, "latest"))


def latest_step(path: str) -> int:
    """The step recorded by the most recent :func:`save_train_state`."""
    with open(os.path.join(path, "latest")) as f:
        return int(f.read().strip())


def load_train_state(path: str, like: Any, step: int | None = None, *,
                     device: Any = None) -> tuple[Any, int]:
    if step is None:
        step = latest_step(path)
    return load_pytree(step_path(path, step), like, device=device), step

