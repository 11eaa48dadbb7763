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

Writes are streamed one leaf at a time, in chunks, so the host never holds
more than a chunk of a device leaf; a restore allocates each leaf once on
its target device and copies the file into it chunk by chunk.  Files go to
``*.tmp`` first and are moved into place with ``os.replace``.
"""

# reprolint: disable-file=RL001
from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Any, Iterator

import numpy as np
import torch

__all__ = [
    "save_pytree",
    "load_pytree",
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


def key_paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(name, leaf)`` pairs in the reference's flatten order and names."""
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from key_paths(getattr(tree, f.name), f"{prefix}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from key_paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from key_paths(v, f"{prefix}[{i}]")
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


def _stored(leaf) -> tuple[torch.Tensor, tuple, str | None]:
    """The flat tensor whose bytes are written, the leaf's shape, and its
    extension-dtype name."""
    t = leaf.get_state() if isinstance(leaf, torch.Generator) else torch.as_tensor(leaf).detach()
    if t.dtype in _NP_OF:
        return t.reshape(-1), tuple(t.shape), None
    # bf16 / f8: numpy cannot hold them — store the bits as a uint view
    ext = str(t.dtype).split(".")[-1]
    return t.reshape(-1).view(_UINT[t.element_size()][0]), tuple(t.shape), ext


def _write_leaf(zf: zipfile.ZipFile, name: str, leaf) -> str | None:
    flat, shape, ext = _stored(leaf)
    np_dtype = np.dtype(_UINT[flat.element_size()][1] if ext else _NP_OF[flat.dtype])
    header = {"descr": np.lib.format.dtype_to_descr(np_dtype), "fortran_order": False,
              "shape": shape}
    per = max(CHUNK_BYTES // max(flat.element_size(), 1), 1)
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array_header_1_0(f, header)
        for i in range(0, flat.numel(), per):
            f.write(flat[i:i + per].cpu().numpy().view(np_dtype).data)
    return ext


def save_pytree(path: str, tree: Any) -> None:
    """Write ``path``.npz (key-path-named arrays) + ``path``.json (manifest)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys, ext_dtypes, generators = [], {}, {}
    tmp = path + ".npz.tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, leaf in key_paths(tree):
            ext = _write_leaf(zf, key, leaf)
            if ext is not None:
                ext_dtypes[key] = ext
            if isinstance(leaf, torch.Generator):
                generators[key] = leaf.device.type
            keys.append(key)
    # write-to-tmp + atomic replace: RE-saving an existing step must never
    # leave a torn npz/json behind an intact 'latest' pointer
    os.replace(tmp, path + ".npz")
    tmp = path + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump({"schema": SCHEMA, "keys": keys, "num_leaves": len(keys),
                   "dtypes": ext_dtypes, "generators": generators}, f, indent=2)
    os.replace(tmp, path + ".json")


def _read_header(f) -> tuple[tuple, np.dtype]:
    version = np.lib.format.read_magic(f)
    read = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}[version]
    shape, fortran, dtype = read(f)
    if fortran and len(shape) > 1:
        raise ValueError("Fortran-ordered arrays are not checkpoint leaves")
    return tuple(shape), dtype


def _read_into(f, out: torch.Tensor, np_dtype: np.dtype) -> None:
    """Fill the contiguous ``out`` (any device) from ``f``, chunk by chunk."""
    flat = out.reshape(-1)
    view = flat.view(_UINT[flat.element_size()][0]) if flat.dtype not in _NP_OF else flat
    per = max(CHUNK_BYTES // np_dtype.itemsize, 1)
    for i in range(0, flat.numel(), per):
        n = min(per, flat.numel() - i)
        raw = f.read(n * np_dtype.itemsize)
        if len(raw) != n * np_dtype.itemsize:
            raise ValueError("checkpoint array is truncated")
        src = np.frombuffer(raw, dtype=np_dtype)
        if src.dtype.kind == "u" and src.dtype.itemsize > 1:
            src = src.view(src.dtype.str.replace("u", "i"))
        view[i:i + n].copy_(torch.from_numpy(src.copy()))


def _load_leaf(zf, path: str, key: str, ref, manifest: dict, device) -> Any:
    gens = manifest.get("generators", {})
    with zf.open(key + ".npy") as f:
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
            state = torch.empty(shape, dtype=torch.uint8)
            _read_into(f, state, np_dtype)
            gen = torch.Generator(device=ref.device)
            gen.set_state(state)
            return gen
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
        target = ref.device if ref.device.type != "meta" else torch.device(device)
        if stored == ref.dtype:
            out = torch.empty(shape, dtype=ref.dtype, device=target)
            _read_into(f, out, np_dtype)
            return out
        # cast to the template's dtype, as the reference does
        tmp = torch.empty(shape, dtype=stored)
        _read_into(f, tmp, np_dtype)
        return tmp.to(device=target, dtype=ref.dtype)


def load_pytree(path: str, like: Any, *, device: Any = None) -> Any:
    """Restore into the structure of ``like``.

    Structure is validated key path by key path: a checkpoint whose leaves do
    not exactly cover the template's raises a :class:`ValueError` naming the
    missing/unexpected paths.  Per-leaf shapes are then checked and dtypes
    cast to the template's.  Each leaf lands on its template leaf's device;
    a ``meta`` template leaf (a shape-only template) lands on ``device``.
    """
    try:
        with open(path + ".json") as f:
            manifest = json.load(f)
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
    pairs = list(key_paths(like))
    keys = [k for k, _ in pairs]
    with zipfile.ZipFile(path + ".npz") as zf:
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
        leaves = [_load_leaf(zf, path, k, ref, manifest, device) for k, ref in pairs]
    return _rebuild(like, iter(leaves))


def save_train_state(path: str, state: Any, step: int) -> None:
    save_pytree(os.path.join(path, f"step_{step:08d}"), state)
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
    return load_pytree(os.path.join(path, f"step_{step:08d}"), like, device=device), step

