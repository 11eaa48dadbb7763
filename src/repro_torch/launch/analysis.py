"""Roofline terms and collective traffic of a planned step (port of
``src/repro/launch/analysis.py``), at the H100 figures of
:data:`repro_torch.launch.mesh.HARDWARE`.

The reference's ``parse_collective_bytes`` sums the collectives of XLA's
partitioned HLO.  The port partitions nothing automatically (each process
runs its own block, and collectives are written out), so there is no HLO to
read: :func:`collective_bytes` counts instead the collectives that the
reference's layout implies (FSDP storage over ``data``, Megatron products
over ``model``), by the formulas in its docstring, and
:func:`port_collective_bytes` the all-reduces and all-gathers the port
itself runs for the archs it shards (its FSDP gathers included; the one
count the port's byte counter is held to exactly).
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


def _data_bytes(cfg, mesh, dtype) -> dict:
    """A rank's param bytes in ``dtype`` by where they sit over ``data``:
    ``whole`` the blocks of the leaves whole over ``data``; of the leaves
    it gathers (:func:`~repro_torch.sharding.specs.gather_dim`), gathered,
    ``outer`` those outside the layer stacks, ``stack`` / ``encoder`` /
    ``decoder`` those of each stack (all its layers), ``cross_kv``
    whisper's cross-attention ``wk`` / ``wv`` (what its cache projects).
    The weights-stationary MoE's expert stacks are in none of them."""
    from repro_torch.sharding.collectives import batch_axes, data_layout

    layout = data_layout(cfg, mesh)
    n_data = mesh.size(batch_axes(mesh))
    out = dict.fromkeys(("whole", "outer", "stack", "encoder", "decoder", "cross_kv"), 0)
    for (path, shape), whole in zip(layout.shapes.items(), layout.whole):
        local = math.prod(shape) * dtype.itemsize
        if whole:
            out["whole"] += local
            continue
        if path not in layout.dims:
            continue
        top = path.split("/", 1)[0]
        out[top if top in ("stack", "encoder", "decoder") else "outer"] += n_data * local
        if path in ("decoder/cross_attn/wk", "decoder/cross_attn/wv"):
            out["cross_kv"] += n_data * local
    return out


def _cache_combine_bytes(cfg, mesh, batch: int, b_loc: int, capacity: int, act_dt,
                         cache_dt) -> tuple[int, int, float]:
    """A decode step's ``kv_gather`` and ``kv_combine`` bytes, and the
    bytes they send, for the attention caches whose capacity
    :func:`~repro_torch.sharding.specs.capacity_split` splits (the
    self-attention caches of ``capacity`` positions, a local layer's ring
    of ``min(window, capacity)``; whisper's cross K/V of its encoder
    positions).  Each such layer combines, over the axes that split it,
    the row maximum (B_loc Nq' 4, a max) and the row sum with the weighted
    values (B_loc Nq' (H + 1) 4, a sum), Nq' the query heads the rank
    attends with: every one where the capacity is split over ``model``
    (whose query heads, split over ``model``, are first gathered: B_loc Nq
    H in the dtype the query has, the residual stream's promoted by the
    layers before), else the rank's."""
    import torch

    from repro_torch.sharding.specs import capacity_split

    n_model = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)
    H, nq = cfg.head_dim, cfg.num_heads
    heads_split = n_model > 1 and nq % n_model == 0
    gathered = combined = 0
    sent = 0.0

    def layer(slots: int, nkv: int, q_dtype) -> None:
        nonlocal gathered, combined, sent
        split = capacity_split((batch, slots, nkv, H), mesh, batch)
        if split is None:
            return
        axes, _, n = split
        every = axes == ("model",)
        if every and heads_split:
            g = b_loc * nq * H * q_dtype.itemsize
            gathered += g
            sent += _ring(n_model, "all-reduce") * g
        heads = nq if every or not heads_split else nq // n_model
        comb = b_loc * heads * 4 + b_loc * heads * (H + 1) * 4
        combined += comb
        sent += _ring(n, "all-reduce") * comb

    xd = act_dt
    if cfg.is_encoder_decoder:
        for _ in range(cfg.num_layers):
            for slots, nkv in ((capacity, cfg.num_kv_heads), (cfg.encoder_positions, nq)):
                layer(slots, nkv, xd)
                xd = torch.promote_types(xd, torch.promote_types(cache_dt, xd))
    else:
        for t in cfg.layer_types():
            if t in ("global", "local"):
                layer(min(cfg.window_size, capacity) if t == "local" else capacity,
                      cfg.num_kv_heads, xd)
                xd = torch.promote_types(xd, torch.promote_types(cache_dt, xd))
    return gathered, combined, sent


def port_collective_bytes(cfg, kind: str, batch: int, seq: int, mesh, *,
                          cache_dtype=None, capacity: int | None = None) -> dict:
    """The collectives ONE rank of the port runs per step under the layout
    ``mesh``, for every arch and every layout option.

    ``counted`` holds, by purpose, the bytes handed to all-reduce (and, for
    the ``sp_*`` purposes, to all-gather and reduce-scatter), exactly
    what :data:`repro_torch.sharding.collectives.COLLECTIVE_BYTES` counts in
    a run of that step (the tests and ``chip_smoke.py`` hold one to the
    other).  ``kind`` is ``train`` (a gradient), ``prefill`` or ``decode``
    (one step), as ``launch/serve.py`` runs them: for whisper its prefill is
    the encoder and the cross K/V (no decoder pass, no greedy pick).  A layer
    runs sharded where the storage layout splits it (``model`` divides its
    heads, d_ff, inner width or vocab), whole otherwise, and then adds
    nothing.  With T = B_loc S tokens through the stack (S = 1 when
    decoding; a vlm adds its P prefix rows), activations of ``a`` bytes
    (in a decode step the dtype the residual stream has then: jnp's
    promotion with the cache's lifts it after the first attention layer),
    under ``model`` > 1:

    * ``embed``: the vocab-parallel lookup of the tokens, B_loc S D a;
    * ``attn`` / ``mlp``: each attention layer's and each MLP's row-parallel
      output, T D a (the MoE's shared expert's too; whisper's encoder over
      its frames, its decoder's self- and cross-attention each); a decode
      step's attention output in the promotion of the cache's and the
      activations' dtype (the f32 cache of the launcher);
    * ``ssm_proj`` / ``ssm_out``: each Mamba layer's (dt, B, C) partial
      sums, T (dt_rank + 2N) a, and its output, T D a;
    * ``lru_gather`` / ``lru_out``: each RG-LRU layer's conv output
      gathered over ``model``, T W a, and its output, T D a (a decode
      step's conv output in the promotion of the cache's dtype);
    * training with ``cfg.remat`` counts the stack's (whisper: the
      decoder's) forward collectives again for the recomputed forward;
    * ``combine`` / ``aux`` / ``gather``: the MoE's expert combine (T D a),
      its load-balance loss (4) and, weights-stationary
      (:func:`repro_torch.models.moe.moe_layout`, which at one ``model``
      rank too), the token gather (n_data T D a, and the combine over every
      rank of the same size);
    * ``logits`` (training, vocab split): the vocab-parallel
      cross-entropy's max, sum of exponentials and target logit, 3 B_loc S 4;
    * ``argmax`` (prefill and decode, vocab split): the greedy pick,
      B_loc (4 + 8);
    * ``backward`` (training): every column-parallel input's cotangent
      (each attention's and MLP's, T D a; the Mamba layer's ``in_proj``
      input and its normed (dt, B, C), T (D + dt_rank + 2N) a; the
      RG-LRU's ``in_x`` / ``in_gate`` input, T D a, and its gather's, T W
      a; whisper's decoder its self- and cross-attention queries and, once,
      the encoder's output; the unembedding's, B_loc S D a), the MoE's
      router (D E 4) and tokens (T D a), aux's data sum (4) and,
      weights-stationary, the token gather's and the combine's cotangents
      summed over ``data`` (n_data T D a each), and the replicated ``wk`` /
      ``wv`` of layers whose kv heads do not split over ``model`` (their
      gradient);
    * with ``cfg.sequence_parallel`` (:func:`repro_torch.sharding.collectives.seq_mesh`:
      training and prefill, ``model`` dividing the P + S positions) the
      residual stream between the blocks is the rank's chunk of the
      sequence: ``sp_gather`` counts each mixer's, MLP's and MoE's input
      gathered over ``model`` (T D a; the MoE's once) and, training, again
      in the backward for the weights' gradients (the MoE's where it feeds
      the router or a split shared expert), the stack's output gathered
      before the final norm's row (T D a, once) and, training, the
      backward gather of every reduce-scatter or cut (T D a each, the
      stack's input among them); ``sp_scatter`` each row-parallel output
      reduce-scattered in place of its ``attn`` / ``mlp`` / ``combine`` /
      ``ssm_out`` / ``lru_out`` all-reduce (T D a) and, training, each
      gather's cotangent (T D a) in place of its column-parallel
      ``backward`` term; ``backward`` adds every norm's gradient and the
      shared expert's gate's (and, held whole, its three weights'), whose
      rows are the rank's chunk, summed over ``model`` (the leaf's bytes);

    and with data > 1 ``fsdp_gather``, every weight the storage layout
    splits over ``data`` gathered (the bytes of the gathered leaf, a rank's
    block over ``model``): training the leaves outside the stacks once and
    each stack's layers in the forward and, under ``cfg.remat``, again in
    the recompute (whisper's encoder, which runs no remat, once); a
    prefill or a decode step once each (whisper's prefill, the encoder and
    the cross-attention's ``wk`` / ``wv``; its decode step, the embedding
    and the decoder's layers but those two, whose K/V the cache holds); and training ``fsdp_grad``, their
    gradients reduce-scattered over ``data`` (the same bytes, once), ``loss``
    (the token count and the loss, 2 x 4), where the MoE routes each
    rank's rows alone ``aux`` (its mean over ``data``, 4), and ``grad``,
    the rank's gradient of the leaves whole over ``data`` (under
    ``replicate_params_over_data`` every leaf).  The clip link's 4-byte
    norm is not counted.  ``all-reduce``, ``all-gather`` and
    ``reduce-scatter`` are the bytes each rank sends (ring: 2 (n - 1) / n
    and (n - 1) / n per byte over the group of n ranks); the other
    collectives are 0.  ``cfg.shard_grads`` changes nothing: the port's
    gradients already come out in each weight's storage layout.

    A decode step under ``SPEC_OPTIONS["seq_shard_cache"]`` adds
    ``kv_gather`` and ``kv_combine`` for every attention cache whose
    capacity is split (:func:`_cache_combine_bytes`), its capacity
    ``capacity`` positions (default ``seq``, the planner's decode cache;
    a serve's is its prompt and its steps).
    """
    import torch

    from repro_torch.models.layers import dtype_of
    from repro_torch.models.moe import moe_layout

    axes = tuple(mesh.axis_names)
    sizes = dict(zip(axes, mesh.devices.shape))
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    n_data = math.prod(sizes[a] for a in batch_axes) if batch_axes else 1
    n_model = sizes.get("model", 1)
    world = n_data * n_model
    train, decode = kind == "train", kind == "decode"
    if batch % n_data and train:
        raise ValueError(f"batch {batch} does not split over {n_data} data ranks")
    act_dt = dtype_of(cfg.activation_dtype)
    a = act_dt.itemsize
    pd = dtype_of(cfg.param_dtype).itemsize
    cd = torch.float32 if cache_dtype is None else cache_dtype
    # a serving batch whose rows do not split stays whole on every data rank
    b_loc = batch // n_data if batch % n_data == 0 else batch
    D = cfg.d_model
    s_dec = 1 if decode else seq
    fwd = 1 + (1 if train and cfg.remat else 0)
    c = {k: 0 for k in ("embed", "attn", "mlp", "combine", "gather", "aux", "logits", "argmax",
                        "ssm_proj", "ssm_out", "lru_gather", "lru_out", "loss", "grad",
                        "fsdp_gather", "fsdp_grad", "backward", "sp_gather", "sp_scatter",
                        "kv_gather", "kv_combine")}
    sent = 0.0
    if decode:
        c["kv_gather"], c["kv_combine"], sent = _cache_combine_bytes(
            cfg, mesh, batch, b_loc, seq if capacity is None else capacity, act_dt, cd)
    tp = n_model > 1
    moe = moe_layout(cfg, mesh) if cfg.num_experts else None
    stationary = bool(moe is not None and moe.stationary)
    if tp or stationary:
        def splits(n: int) -> bool:
            return tp and n % n_model == 0

        heads, vocab = splits(cfg.num_heads), splits(cfg.vocab_size)
        ffn = cfg.shared_expert_ff if cfg.num_experts else cfg.d_ff
        mlp = bool(ffn) and splits(ffn)
        xd = act_dt  # the residual stream's dtype, as a decode step promotes it
        back = back_data = 0

        def attn_layer(tok, repeat):
            """An attention layer's output; its dtype under a decode step's
            promotion with the cache's."""
            od = torch.promote_types(cd, xd) if decode else xd
            if heads:
                c["attn"] += repeat * tok * D * od.itemsize
            return od

        if cfg.is_encoder_decoder:
            t_enc = 0 if decode else b_loc * cfg.encoder_positions
            tok = 0 if kind == "prefill" else b_loc * s_dec
            c["attn"] += cfg.num_encoder_layers * t_enc * D * a * heads
            c["mlp"] += cfg.num_encoder_layers * t_enc * D * a * mlp
            for _ in range(cfg.num_layers):
                for _cross in range(2):  # self-attention, then cross-attention
                    xd = torch.promote_types(xd, attn_layer(tok, fwd))
                c["mlp"] += fwd * tok * D * xd.itemsize * mlp
            back = (cfg.num_encoder_layers * t_enc * D * a * (heads + mlp)
                    + cfg.num_layers * tok * D * a * (2 * heads + mlp) + t_enc * D * a * heads)
            emb_tok = tok
        else:
            n_pre = cfg.num_prefix_embeddings if cfg.frontend == "vision" and not decode else 0
            tok = b_loc * (s_dec + n_pre)
            sp = bool(cfg.sequence_parallel and tp and not decode
                      and (s_dec + n_pre) % n_model == 0)
            ta = tok * D * a  # a block input's bytes, the whole sequence
            norm = (2 if cfg.norm_type == "layernorm" else 1) * D * pd  # a norm's leaves

            def enter_leave(split: bool, gather: bool = True):
                """A layer's sequence-parallel gather (``gather``: forward,
                again in the backward for its weights' gradients, and its
                cotangent reduce-scattered when ``split``) and its output
                reduce-scattered (``split``, the layer split over
                ``model``) or cut (whole), forward and backward."""
                c["sp_gather"] += (fwd + train) * ta * gather + train * ta
                c["sp_scatter"] += (fwd * ta + train * ta * gather) * split

            W, N, dtr = cfg.lru_width or D, cfg.ssm_state, cfg.dt_rank
            for t in cfg.layer_types():
                if sp and train:
                    back += norm * (1 + (t != "ssm") * (not cfg.parallel_residual)
                                    + (t != "ssm") * 2 * cfg.use_post_norms)
                if t == "ssm":
                    if sp:
                        enter_leave(splits(cfg.d_inner))
                    if splits(cfg.d_inner):
                        wd = torch.promote_types(cd, xd) if decode else xd
                        c["ssm_proj"] += fwd * tok * (dtr + 2 * N) * wd.itemsize
                        c["ssm_out"] += 0 if sp else fwd * tok * D * xd.itemsize
                        back += tok * ((0 if sp else D) + dtr + 2 * N) * a
                    continue
                if t == "recurrent":
                    if sp:
                        enter_leave(splits(W))
                    if splits(W):
                        wd = torch.promote_types(cd, xd) if decode else xd
                        c["lru_gather"] += fwd * tok * W * wd.itemsize
                        c["lru_out"] += 0 if sp else fwd * tok * D * xd.itemsize
                        back += tok * ((0 if sp else D) + W) * a
                    hd = xd
                else:
                    if sp:
                        enter_leave(heads)
                        hd = xd
                    else:
                        hd = attn_layer(tok, fwd)
                    if heads:
                        back += 0 if sp else tok * D * a
                        if cfg.num_kv_heads % n_model:
                            kv = 2 * D * cfg.num_kv_heads * cfg.head_dim
                            back += kv * pd
                # the MLP reads the normed residual, or with a parallel
                # residual the block's input
                md = xd if cfg.parallel_residual else torch.promote_types(xd, hd)
                m_act = tok * D * md.itemsize
                if cfg.num_experts:
                    if sp:  # the MoE's input, gathered once (again in the backward
                        # where the gather feeds the router or a split shared
                        # expert); its shared gate, and a shared expert held
                        # whole, on the chunk
                        c["sp_gather"] += (fwd + train * (not stationary or mlp)) * ta
                        c["sp_scatter"] += train * ta
                        if mlp:
                            enter_leave(True, gather=False)
                        fs = cfg.shared_expert_ff
                        back += train * (D + (0 if mlp else 3 * D * fs)) * pd * bool(fs)
                    elif mlp:
                        c["mlp"] += fwd * m_act
                        back += tok * D * a
                    tokens = n_data * m_act if stationary else m_act
                    if stationary:
                        c["gather"] += fwd * tokens
                        c["combine"] += fwd * tokens
                        back_data += 2 * n_data * tok * D * a
                        if sp:
                            c["sp_gather"] += train * ta  # the cut's backward gather
                    elif sp:
                        enter_leave(True, gather=False)
                    else:
                        c["combine"] += fwd * tokens
                    c["aux"] += fwd * 4
                    back_data += 4 if batch_axes else 0
                    if tp:
                        back += D * cfg.experts_padded * 4
                        back += 0 if sp else (n_data * tok if stationary else tok) * D * a
                elif sp:
                    enter_leave(mlp)
                elif mlp:
                    c["mlp"] += fwd * m_act
                    back += tok * D * a
                xd = torch.promote_types(xd, hd)
            if sp:  # the stack's input cut, its output gathered, the final norm
                c["sp_gather"] += ta + train * ta
                back += train * norm
            emb_tok = b_loc * s_dec
        if vocab:
            c["embed"] = emb_tok * D * a
            if train:
                c["logits"] = 3 * b_loc * s_dec * 4
                back += b_loc * s_dec * D * a
            elif not (cfg.is_encoder_decoder and kind == "prefill"):
                c["argmax"] = b_loc * (4 + 8)
        if train:
            c["backward"] = back + back_data
        m_ring = _ring(n_model, "all-reduce")
        sent += m_ring * (train * back + sum(c[k] for k in ("embed", "attn", "mlp", "logits",
                                                             "argmax", "ssm_proj", "ssm_out",
                                                             "lru_gather", "lru_out")))
        if cfg.num_experts:
            sent += _ring(world if stationary else n_model, "all-reduce") * c["combine"]
            sent += _ring(n_data, "all-reduce") * (c["gather"] + train * back_data)
            sent += _ring(world, "all-reduce") * c["aux"]
    gathered = 0.0
    if n_data > 1:
        pd = dtype_of(cfg.param_dtype) if train else torch.float32
        g = _data_bytes(cfg, mesh, pd)
        if not cfg.is_encoder_decoder:
            c["fsdp_gather"] = g["outer"] + fwd * g["stack"]
        elif train:
            c["fsdp_gather"] = g["outer"] + g["encoder"] + fwd * g["decoder"]
        else:
            c["fsdp_gather"] = (g["encoder"] + g["cross_kv"] if kind == "prefill"
                                else g["outer"] + g["decoder"] - g["cross_kv"])
        gathered = _ring(n_data, "all-gather") * c["fsdp_gather"]
    if train and n_data > 1:
        c["loss"] = 2 * 4
        mean_aux = 4 if cfg.num_experts and not moe.sharded else 0
        c["aux"] += mean_aux
        c["fsdp_grad"] = sum(g[k] for k in ("outer", "stack", "encoder", "decoder"))
        c["grad"] = g["whole"]
        sent += _ring(n_data, "all-reduce") * (c["loss"] + c["grad"] + mean_aux)
    out = {k: 0.0 for k in _COLLECTIVES}
    out["all-reduce"] = sent
    out["all-gather"] = gathered + _ring(n_model, "all-gather") * c["sp_gather"]
    out["reduce-scatter"] = (_ring(n_data, "reduce-scatter") * c["fsdp_grad"]
                             + _ring(n_model, "reduce-scatter") * c["sp_scatter"])
    out["total"] = out["all-reduce"] + out["all-gather"] + out["reduce-scatter"]
    out["counted"] = c
    out["counted_total"] = sum(c.values())
    return out
