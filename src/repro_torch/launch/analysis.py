"""Roofline terms and collective traffic of a planned step (port of
``src/repro/launch/analysis.py``), at the H100 figures of
:data:`repro_torch.launch.mesh.HARDWARE`.

The reference's ``parse_collective_bytes`` sums the collectives of XLA's
partitioned HLO.  The port partitions nothing automatically (each process
runs its own block, and collectives are written out), so there is no HLO to
read: :func:`collective_bytes` counts instead the collectives that the
layout implies, by the formulas in its docstring.
"""

from __future__ import annotations

import math

from repro_torch.launch.mesh import HARDWARE

__all__ = ["collective_bytes", "roofline_terms", "model_flops", "peak_flops_for"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def peak_flops_for(dtype_name: str) -> float:
    """The card's dense peak for products in ``dtype_name`` (bf16 / fp16 on
    the tensor cores; f32 outside them, as the port keeps TF32 off)."""
    return HARDWARE["peak_flops_f32"] if dtype_name == "float32" else HARDWARE["peak_flops_bf16"]


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    *,
    num_chips: int,
    per_device: bool = True,
    peak_flops: float | None = None,
) -> dict[str, float]:
    """The three roofline terms in seconds and the dominant one.

    ``per_device=True``: flops and bytes already describe one card's share;
    otherwise they are divided by ``num_chips``.  Compute is over
    ``peak_flops`` (default the bf16 peak), memory over the HBM rate, and
    collectives over the card's NVLink (18 links x 25 GB/s each way), in
    place of the reference's ICI links.
    """
    div = 1.0 if per_device else float(num_chips)
    peak = HARDWARE["peak_flops_bf16"] if peak_flops is None else peak_flops
    t_comp = (flops / div) / peak
    t_mem = (hbm_bytes / div) / HARDWARE["hbm_bandwidth"]
    links = HARDWARE["nvlink_links_per_card"] * HARDWARE["nvlink_link_bandwidth"]
    t_coll = (collective_bytes / div) / links
    dominant = max((t_comp, "compute"), (t_mem, "memory"), (t_coll, "collective"))[1]
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
    }


def model_flops(cfg, *, batch: int, seq: int, kind: str) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active params
    (the reference's formula)."""
    n_active = cfg.active_param_count()
    tokens = batch * seq if kind in ("train", "prefill") else batch  # decode: 1 token
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def _ring(n: int, kind: str) -> float:
    """Bytes each rank sends, per byte of the full buffer, in a ring
    algorithm over ``n`` ranks."""
    if n <= 1:
        return 0.0
    return (2.0 if kind == "all-reduce" else 1.0) * (n - 1) / n


def _row_parallel(path: str) -> bool:
    """Leaves that end a product sharded over ``model``: their output is a
    partial sum over the model ranks (one all-reduce of the activation)."""
    leaf = path.rsplit("/", 1)[-1]
    return leaf in ("wo", "w_down", "out_proj", "w_down_e")


def collective_bytes(cfg, kind: str, batch: int, seq: int, mesh) -> dict[str, float]:
    """Bytes ONE card sends per step under the layout ``mesh`` (ring
    algorithms: an all-gather or reduce-scatter over n ranks sends (n-1)/n of
    the full buffer, an all-reduce twice that).

    * all-gather: every weight sharded over the batch axes (``data``/``pod``)
      is gathered once per step (the FSDP storage layout); its full size is
      its model-local block (spec over ``model`` kept);
    * reduce-scatter (train): each such weight's gradient, once;
    * all-reduce: every product sharded over ``model`` ends in a partial
      sum, one all-reduce of the (B_loc, S, D) activation in the
      activation dtype per row-parallel leaf per layer (``wo``, ``w_down``,
      ``out_proj``, ``w_down_e``: two per transformer layer, attention and
      MLP), doubled for the backward pass when training.  S is 1 when
      decoding, and the encoder's positions for whisper's encoder layers;
    * the MoE with ``cfg.moe_weights_stationary`` and a batch axis that
      divides d_ff: per MoE layer the token gather (an all-reduce of the
      zero-filled (n_data, T_loc, D) buffer over the batch axes) and the
      combine summed over every rank instead of over ``model``.
    """
    from repro_torch.models import model as M
    from repro_torch.models.layers import dtype_of
    from repro_torch.sharding.specs import leaf_paths, local_shape, param_spec_for

    axes = tuple(mesh.axis_names)
    sizes = dict(zip(axes, mesh.devices.shape))
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    n_data = math.prod(sizes[a] for a in batch_axes) if batch_axes else 1
    n_model = sizes.get("model", 1)
    act_bytes = dtype_of(cfg.activation_dtype).itemsize
    b_loc = batch // n_data if batch % n_data == 0 else batch
    s_dec = 1 if kind == "decode" else seq
    passes = 2 if kind == "train" else 1
    stationary = bool(cfg.moe_weights_stationary and batch_axes
                      and cfg.d_ff_expert % n_data == 0)

    out = {c: 0.0 for c in _COLLECTIVES}
    for path, leaf in leaf_paths(M.init_model(None, cfg, "meta")):
        shape = tuple(leaf.shape)
        spec = param_spec_for(path, shape, mesh)
        item = leaf.element_size()
        gathered = [e for e in spec if e is not None and e != "model"]
        if gathered:
            model_only = tuple(e if e == "model" else None for e in spec)
            full = math.prod(local_shape(shape, model_only, mesh)) * item
            out["all-gather"] += _ring(n_data, "all-gather") * full
            if kind == "train":
                out["reduce-scatter"] += _ring(n_data, "reduce-scatter") * full
        if _row_parallel(path) and "model" in spec and n_model > 1:
            trailing = 3 if path.endswith(("wo", "w_down_e")) else 2  # (h, hd, d), (E, f, d)
            layers = math.prod(shape[:len(shape) - trailing])
            s = cfg.encoder_positions if path.startswith("encoder") else s_dec
            act = b_loc * s * cfg.d_model * act_bytes
            if path.endswith("w_down_e") and stationary:
                world = n_model * n_data
                out["all-reduce"] += layers * _ring(n_data, "all-reduce") * n_data * act
                out["all-reduce"] += layers * passes * _ring(world, "all-reduce") * n_data * act
            else:
                out["all-reduce"] += layers * passes * _ring(n_model, "all-reduce") * act
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out
