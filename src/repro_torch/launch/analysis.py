"""Roofline terms and collective traffic of a planned step (port of
``src/repro/launch/analysis.py``), at the H100 figures of
:data:`repro_torch.launch.mesh.HARDWARE`.

The reference's ``parse_collective_bytes`` sums the collectives of XLA's
partitioned HLO.  The port partitions nothing automatically (each process
runs its own block, and collectives are written out), so there is no HLO to
read: :func:`collective_bytes` counts instead the collectives that the
reference's layout implies (FSDP storage over ``data``, Megatron products
over ``model``), by the formulas in its docstring, and
:func:`port_collective_bytes` the all-reduces the port itself runs for the
archs it shards (every weight whole over ``data``; the one count the
port's byte counter is held to exactly).
"""

from __future__ import annotations

import math

from repro_torch.launch.mesh import HARDWARE

__all__ = ["collective_bytes", "port_collective_bytes", "roofline_terms", "model_flops",
           "peak_flops_for"]

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


def port_collective_bytes(cfg, kind: str, batch: int, seq: int, mesh, *,
                          cache_dtype=None) -> dict:
    """The all-reduces ONE rank of the port runs per step under the layout
    ``mesh``, for an arch every layer of which the port shards
    (:func:`repro_torch.sharding.specs.tensor_parallel_unsupported` is None).

    ``counted`` holds, by purpose, the bytes handed to all-reduce, exactly
    what :data:`repro_torch.sharding.collectives.COLLECTIVE_BYTES` counts in
    a run of that step (the tests and ``chip_smoke.py`` hold one to the
    other).  With L layers, T = B_loc S tokens (S = 1 when decoding) and
    activations of ``a`` bytes, under ``model`` > 1:

    * ``embed``: the vocab-parallel lookup, T D a;
    * ``attn`` / ``mlp``: each layer's row-parallel output, T D a (the MLP's,
      or the MoE's shared expert's); a decode step's attention output in
      the promotion of the cache's and the activations' dtype (the f32
      cache of the launcher); training with ``cfg.remat`` counts them again
      for the recomputed forward;
    * ``combine`` / ``aux`` / ``gather``: the MoE's expert combine (T D a),
      its load-balance loss (4) and, weights-stationary, the token gather
      (n_data T D a, and the combine over every rank of the same size);
    * ``logits`` (training): the vocab-parallel cross-entropy's max, sum of
      exponentials and target logit, 3 T 4;
    * ``argmax`` (prefill and decode): the greedy pick, B_loc (4 + 8);
    * ``backward`` (training): each layer's two column-parallel inputs
      (attention and MLP: 2 T D a), the unembedding's (T D a), the
      MoE's router (D E 4) and tokens (T D a) and aux's data sum (4), and
      the replicated ``wk`` / ``wv`` of layers whose kv heads do not split
      over ``model`` (their gradient);

    and with data > 1 (training) ``loss`` (the token count and the loss, 2 x
    4), with one model rank the MoE's ``aux`` (its mean over ``data``, 4), and
    ``grad``, the rank's flat gradient (its blocks, every leaf
    replicated over ``data``).  No FSDP all-gather: the port keeps every
    weight whole over ``data``.  The clip link's 4-byte norm is not counted.
    ``all-reduce`` is the bytes each rank sends (ring: 2 (n - 1) / n per
    byte over the group of n ranks); the other collectives are 0.
    """
    import torch

    from repro_torch.models.layers import dtype_of
    from repro_torch.sharding.specs import local_template
    from repro_torch.tree import tree_leaves

    axes = tuple(mesh.axis_names)
    sizes = dict(zip(axes, mesh.devices.shape))
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    n_data = math.prod(sizes[a] for a in batch_axes) if batch_axes else 1
    n_model = sizes.get("model", 1)
    world = n_data * n_model
    train = kind == "train"
    if batch % n_data and train:
        raise ValueError(f"batch {batch} does not split over {n_data} data ranks")
    a = dtype_of(cfg.activation_dtype).itemsize
    # a serving batch whose rows do not split stays whole on every data rank
    b_loc = batch // n_data if batch % n_data == 0 else batch
    tok = b_loc * (1 if kind == "decode" else seq)
    act = tok * cfg.d_model * a
    layers = cfg.num_layers
    fwd = 1 + (1 if train and cfg.remat else 0)
    c = {k: 0 for k in ("embed", "attn", "mlp", "combine", "gather", "aux", "logits", "argmax",
                        "loss", "grad", "backward")}
    sent = 0.0
    if n_model > 1:
        attn_a = a
        if kind == "decode":
            cd = torch.float32 if cache_dtype is None else cache_dtype
            attn_a = torch.promote_types(cd, dtype_of(cfg.activation_dtype)).itemsize
        c["embed"] = act
        c["attn"] = fwd * layers * tok * cfg.d_model * attn_a
        mlp_layers = layers if (not cfg.num_experts or cfg.shared_expert_ff) else 0
        c["mlp"] = fwd * mlp_layers * act
        stationary = False
        if cfg.num_experts:
            stationary = bool(cfg.moe_weights_stationary and batch_axes
                              and cfg.d_ff_expert % n_data == 0)
            c["combine"] = fwd * layers * (n_data * act if stationary else act)
            c["gather"] = fwd * layers * n_data * act if stationary else 0
            c["aux"] = fwd * layers * 4
        if train:
            c["logits"] = 3 * tok * 4
            back = layers * (2 if mlp_layers else 1) * act + act
            if cfg.num_experts:
                tokens = n_data * act if stationary else act
                back += layers * (cfg.d_model * cfg.experts_padded * 4 + tokens
                                  + (2 * tokens if stationary else 0)
                                  + (4 if batch_axes else 0))
            if cfg.num_kv_heads % n_model:
                kv = 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
                back += layers * kv * dtype_of(cfg.param_dtype).itemsize
            c["backward"] = back
        else:
            c["argmax"] = b_loc * (4 + 8)
        m_ring = _ring(n_model, "all-reduce")
        sent += m_ring * (c["embed"] + c["attn"] + c["mlp"] + c["logits"] + c["argmax"])
        if cfg.num_experts:
            sent += _ring(world if stationary else n_model, "all-reduce") * c["combine"]
            sent += _ring(n_data, "all-reduce") * c["gather"]
            sent += _ring(world, "all-reduce") * c["aux"]
        sent += m_ring * c["backward"]
    if train and n_data > 1:
        c["loss"] = 2 * 4
        if cfg.num_experts and n_model == 1:
            c["aux"] = 4
        local = local_template(cfg, mesh)
        c["grad"] = sum(math.prod(s) * dt.itemsize for s, dt in tree_leaves(local))
        sent += _ring(n_data, "all-reduce") * (c["loss"] + c["grad"]
                                               + (c["aux"] if n_model == 1 else 0))
    out = {k: 0.0 for k in _COLLECTIVES}
    out["all-reduce"] = sent
    out["total"] = sent
    out["counted"] = c
    out["counted_total"] = sum(c.values())
    return out
