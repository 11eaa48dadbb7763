"""Shape-only stand-ins for every step's arguments, allocating nothing (port
of ``src/repro/launch/input_specs.py``).

``input_specs(arch, shape_name)`` returns the arguments of the step that the
input shape exercises, as ``meta`` tensors built by the port's own
constructors, so the stand-ins always match the real trees:

* ``train_*``   -> (TrainState, batch): the MindTheStep async step's state,
  its delayed-gradient ring and adaptation tables;
* ``prefill_*`` -> (params, batch);
* ``decode_*`` / ``long_*`` -> (params, cache, token, pos), the cache in
  ``CACHE_DTYPE``.

A TrainState's ``rng`` is a ``torch.Generator`` (on the CPU: it holds no
device memory), where the reference's is a ``uint32[2]`` key.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.models import model as M
from repro_torch.optim import transform as T
from repro_torch.sharding.specs import batch_shape_structs

__all__ = ["input_specs", "step_for", "specs_for_cfg", "step_for_cfg", "ring_size_for",
           "workers_for", "cfg_for", "CACHE_DTYPE"]

CACHE_DTYPE = torch.bfloat16
META = torch.device("meta")


def cfg_for(arch: str, *, unroll: bool = False):
    """The arch's config; ``unroll`` turns the reference's scan-over-layers
    off (the port runs its layers as a Python loop either way, so the
    planner's counts do not depend on it)."""
    cfg = get_config(arch)
    if unroll:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    return cfg


def ring_size_for(cfg) -> int:
    """Delayed-gradient ring depth: 8 slots, shrunk for very large models so
    the ring fits beside the params (the reference's rule)."""
    params = cfg.param_count()
    if params > 100e9:
        return 2
    if params > 20e9:
        return 4
    return 8


def workers_for(cfg) -> int:
    """Simulated async workers per tick, bounded by the ring so that sampled
    delays are servable."""
    return max(1, ring_size_for(cfg) // 2)


def _default_adapt(cfg, *, alpha_c: float = 0.01):
    """The AdaptState of the launcher's recipe, as meta tensors."""
    from repro_torch.training.adapt import default_adapt_setup

    _, _, adapt = default_adapt_setup(alpha_c, workers_for(cfg), ring_size_for(cfg), device=META)
    return adapt


def _train_pipeline(alpha_c: float = 0.01) -> T.Chain:
    """The planned training pipeline, shared by the specs and the step so
    that the state's opt_state matches the step."""
    return T.chain(T.scale(-alpha_c))


def _train_specs(cfg, *, batch: int, seq: int):
    from repro_torch.training.steps import init_train_state

    state = init_train_state(cfg, _train_pipeline(), device="cpu",
                             async_ring=ring_size_for(cfg), adapt=_default_adapt(cfg),
                             params=M.init_model(None, cfg, META))
    return (state, batch_shape_structs(cfg, batch=batch, seq=seq))


def _prefill_specs(cfg, *, batch: int, seq: int):
    return (M.init_model(None, cfg, META), batch_shape_structs(cfg, batch=batch, seq=seq))


def _decode_specs(cfg, *, batch: int, seq: int):
    params = M.init_model(None, cfg, META)
    aux_batch = batch_shape_structs(cfg, batch=batch, seq=8)  # enc_embeds only
    cache = M.init_decode_state(params, cfg, batch, seq, cache_dtype=CACHE_DTYPE,
                                batch=aux_batch if cfg.is_encoder_decoder else None)
    token = torch.empty((batch,), dtype=torch.int32, device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)
    return (params, cache, token, pos)


def specs_for_cfg(cfg, shape_name: str) -> tuple:
    seq, batch, kind = INPUT_SHAPES[shape_name]
    make = {"train": _train_specs, "prefill": _prefill_specs, "decode": _decode_specs}[kind]
    return make(cfg, batch=batch, seq=seq)


def input_specs(arch: str, shape_name: str, *, unroll: bool = False) -> tuple:
    return specs_for_cfg(cfg_for(arch, unroll=unroll), shape_name)


def step_for_cfg(cfg, shape_name: str, *, alpha_c: float = 0.01):
    """The step the planner runs for this combination: the async training
    step, the prefill (logits and cache) or one decode step."""
    from repro_torch.training.steps import make_serve_step, make_step

    seq, batch, kind = INPUT_SHAPES[shape_name]
    if kind == "train":
        return make_step(cfg, _train_pipeline(alpha_c), mode="async", alpha_c=alpha_c,
                         num_workers=workers_for(cfg))
    if kind == "prefill":
        # vlm: the vision prefix takes cache slots ahead of the tokens
        capacity = seq + (cfg.num_prefix_embeddings if cfg.frontend == "vision" else 0)

        def prefill_step(params, batch_d):
            logits, cache = M.prefill(params, batch_d, cfg, capacity, cache_dtype=CACHE_DTYPE)
            return {"logits": logits, "cache": cache}

        return prefill_step
    return make_serve_step(cfg)


def step_for(arch: str, shape_name: str, *, alpha_c: float = 0.01, unroll: bool = False):
    return step_for_cfg(cfg_for(arch, unroll=unroll), shape_name, alpha_c=alpha_c)
