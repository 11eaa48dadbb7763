"""What the tensor-parallel tests share: the reduced configs and the run
specs that the one-process and the sharded runs both take
(``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_tp_archs.py``
and their spawned ranks, ``tests/test_torch_cuda_tensor_parallel.py``).
Imports no JAX."""

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.optim import transform as T
from repro_torch.training import default_adapt_setup

B, S, GEN, TICKS = 2, 16, 8, 4


def config(variant):
    cfg = reduced(get_config("stablelm-1.6b"), d_model=64)
    return dataclasses.replace(cfg, num_kv_heads=1) if variant == "kv1" else cfg


# The other families at d_model 64, each cut as the reference's ``reduced``
# cuts it, and then: recurrentgemma-9b to one (recurrent, recurrent, local)
# period and a remainder recurrent layer; whisper-large-v3's vocab to 514,
# which as its 51,866 splits over 2 ranks and not over 4; internvl2-2b's to
# 515, odd as its 92,553, so its embedding, unembedding and logits stay whole.
ARCH_UPDATES = {
    "falcon-mamba-7b": {},
    "recurrentgemma-9b": {"num_layers": 4},
    "whisper-large-v3": {"vocab_size": 514},
    "internvl2-2b": {"vocab_size": 515},
}
ARCHS = tuple(ARCH_UPDATES)


def arch_config(arch, reduce=reduced, get=get_config):
    """``arch`` reduced for the tensor-parallel tests (``ARCH_UPDATES``);
    ``reduce`` / ``get`` of the reference give its twin."""
    return dataclasses.replace(reduce(get(arch), d_model=64), **ARCH_UPDATES[arch])


def async_spec(cfg, params, draws, device="cpu"):
    """4 fused async ticks: momentum, W = K = 4, a refresh every 2, the
    uniforms handed in."""
    from repro_torch.run import RunSpec

    lr = 0.05
    sched, _, adapt = default_adapt_setup(lr, 4, 4, device="cpu")
    link = T.scale_by_staleness(sched, lr, m=4, tau_max=adapt.tau_max)
    it = iter(draws)
    return RunSpec(cfg=cfg, pipeline=T.chain(link, T.scale(-lr), T.trace(0.9)), mode="async",
                   num_steps=TICKS, batch_size=B, seq_len=S, num_workers=4, ring=4, adapt=adapt,
                   fuse=True, params=params, refresh_every=2, seed=0, device=device,
                   tau_source=lambda: torch.from_numpy(next(it)))


def arch_async_spec(cfg, params, draws, device="cpu"):
    """:func:`async_spec` for 3 ticks on the batches ``make_batch_for``
    draws (the vision prefix and the encoder frames included), step t's
    from seed t."""
    from repro_torch.data import make_batch_for

    return dataclasses.replace(
        async_spec(cfg, params, draws, device), num_steps=3,
        batch_fn=lambda t: make_batch_for(cfg, batch=B, seq=S, seed=t, device=device))


def clip_spec(cfg, params, device="cpu"):
    """2 sync fused steps whose clip binds."""
    from repro_torch.run import RunSpec

    pipe = T.chain(T.clip_by_global_norm(0.05), T.scale(-0.05), T.trace(0.9))
    return RunSpec(cfg=cfg, pipeline=pipe, mode="sync", num_steps=2, batch_size=B, seq_len=S,
                   fuse=True, params=params, seed=0, device=device)


class Tables:
    """Every tick's loss, alpha table, CDF and histogram."""

    def __init__(self):
        self.rows = []

    def on_start(self, ctx):
        pass

    def on_refresh(self, ctx):
        pass

    def on_tick(self, ctx):
        a = ctx.state.adapt
        self.rows.append((ctx.metrics["loss"].clone(), a.alpha_table.clone(), a.tau_cdf.clone(),
                          a.hist.clone()))

    def on_end(self, ctx):
        pass

    def arrays(self):
        return {f"{k}": np.stack([r[i].cpu().numpy() for r in self.rows])
                for i, k in enumerate(("losses", "tables", "cdfs", "hists"))}


# ---------------------------------------------------------------------------
# Checkpoints of multi-process states (tests/test_torch_tp_checkpoint.py and
# its spawned ranks)
# ---------------------------------------------------------------------------

SAVE_AT, MORE = 3, 3
VARIANTS = ("momentum", "adam", "unfused")


def ckpt_spec(variant, cfg, params, draws, start, num_steps=TICKS):
    """:func:`async_spec`'s run as ``variant`` (fused momentum, fused adam
    or unfused momentum) from tick ``start`` on, with the uniforms of the
    ticks it runs."""
    s = dataclasses.replace(async_spec(cfg, params, draws[start:]), num_steps=num_steps)
    if variant == "adam":
        link = T.staleness_link(s.pipeline)
        s = dataclasses.replace(s, pipeline=T.chain(link, T.scale_by_adam(), T.scale(-0.05)))
    return dataclasses.replace(s, fuse=variant != "unfused")


def arch_ckpt_spec(cfg, params, draws, start):
    """:func:`arch_async_spec`'s run for ``TICKS`` ticks from ``start``."""
    return dataclasses.replace(arch_async_spec(cfg, params, draws[start:]), num_steps=TICKS)


def sharded_spec(mesh, fuse):
    """The sharded engine of ``test_two_gloo_processes_match_one`` (W 4:
    geometric and Poisson workers, K 8, momentum) for 6 ticks with a
    refresh every 4, so a save at 3 holds a partial histogram."""
    from repro_torch.core import staleness as TS
    from repro_torch.core.step_size import make_schedule
    from repro_torch.run import RunSpec
    from repro_torch.training import make_worker_adapt

    sched = make_schedule("constant", 0.05, tau_max=31)
    adapt = make_worker_adapt(sched.table, [TS.Geometric(0.3), TS.Geometric(0.6),
                                            TS.Poisson(2.0), TS.Poisson(5.0)], cdf_support=8)
    pipe = T.chain(T.scale_by_staleness(sched, 0.05, m=4, tau_max=31), T.scale(-0.05),
                   T.trace(0.9))
    return RunSpec(cfg=config("mha"), pipeline=pipe, mode="sharded_async", num_steps=6,
                   batch_size=B, seq_len=S, ring=8, adapt=adapt, fuse=fuse, refresh_every=4,
                   seed=0, device="cpu", mesh=mesh)


def bits(t):
    """A leaf's bits as numpy: a generator's state, a tensor as integers of
    its width."""
    if isinstance(t, torch.Generator):
        return t.get_state().numpy()
    t = t.detach().contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()]).numpy().copy()


def np_bits(a):
    """A numpy array's bits, as integers of its width."""
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


def state_bits(state):
    from repro_torch.checkpoint import key_paths

    return {k: bits(v) for k, v in key_paths(state)}


def differ(a, b):
    """The leaves of two states that are not bit for bit equal."""
    a, b = state_bits(a), state_bits(b)
    assert list(a) == list(b)
    return [k for k in a if not np.array_equal(a[k], b[k])]


def restored(spec, directory, step=SAVE_AT):
    """The state ``run(spec, resume_from=directory)`` starts from."""
    from repro_torch.run.ckpt import restore_checkpoint
    from repro_torch.run.engine import make_engine

    engine = make_engine(spec)
    return restore_checkpoint(directory, engine.build_template(), spec.pipeline, step=step,
                              device="cpu", layout=engine.checkpoint_layout())[0]


def file_leaves(directory, step=SAVE_AT):
    """A checkpoint's manifest and its leaves as numpy, by key."""
    import json
    import os

    base = os.path.join(str(directory), f"step_{step:08d}")
    with open(base + ".json") as f:
        manifest = json.load(f)
    data = np.load(base + ".npz")
    return manifest, {k: data[k] for k in manifest["keys"]}


def blocks_of(key, whole, local_shape, cfg, mesh):
    """``mesh``'s rank's block of the whole leaf ``key``, as bits, cut
    with ``specs.local_shard``: a leaf named like a param leaf by its
    spec, a flat leaf param by param along its last dim; a leaf of the
    same shape is whole on every rank."""
    from repro_torch.sharding.specs import P, local_shard, storage_spec_for
    from repro_torch.training.steps import param_template
    from repro_torch.tree import keystr, tree_paths

    whole = np_bits(whole)
    if tuple(whole.shape) == tuple(local_shape):
        return whole
    t = torch.from_numpy(whole)
    params = [(keystr(path), "/".join(path), tuple(shape))
              for path, (shape, _) in tree_paths(param_template(cfg))]
    named = [p for p in params if key.endswith(p[0])]
    if named:
        _, name, shape = max(named, key=lambda p: len(p[0]))
        lead = (None,) * (t.dim() - len(shape))
        spec = P(*(lead + tuple(storage_spec_for(name, shape, mesh, cfg))))
        return local_shard(t, spec, mesh, name).contiguous().numpy()
    out = []
    for row in t.reshape(-1, t.shape[-1]):
        start = 0
        for _, name, shape in params:
            n = int(np.prod(shape))
            leaf = row[start:start + n].reshape(shape)
            out.append(local_shard(leaf, storage_spec_for(name, shape, mesh, cfg), mesh, name)
                       .reshape(-1))
            start += n
    return torch.cat(out).reshape(tuple(t.shape[:-1]) + (-1,)).numpy()


def blocks_differ(directory, state, cfg, mesh):
    """The leaves of a rank's ``state`` that are not bit for bit its
    blocks of the checkpoint's."""
    _, whole = file_leaves(directory)
    return [k for k, v in state_bits(state).items()
            if not np.array_equal(blocks_of(k, whole[k], v.shape, cfg, mesh), v)]


# ---------------------------------------------------------------------------
# FSDP storage over data (tests/test_torch_fsdp.py and its spawned ranks)
# ---------------------------------------------------------------------------

FSDP_GEN = 4


def fsdp_arch_config(arch):
    """``arch`` at d_model 64, cut as ``ARCH_UPDATES`` cuts the four
    families it names."""
    return dataclasses.replace(reduced(get_config(arch), d_model=64),
                               **ARCH_UPDATES.get(arch, {}))


def mode_spec(mode, fuse, cfg, params, draws):
    """2 ticks of ``mode`` (sync: momentum alone; async: :func:`async_spec`'s),
    fused or link by link."""
    if mode == "async":
        return dataclasses.replace(async_spec(cfg, params, draws), num_steps=2, fuse=fuse)
    pipe = T.chain(T.scale(-0.05), T.trace(0.9))
    return dataclasses.replace(clip_spec(cfg, params), pipeline=pipe, fuse=fuse)


def digest(t) -> str:
    """SHA-256 of a tensor's bits (a state's leaves compared exactly)."""
    import hashlib

    t = t.detach().contiguous()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


REPL = "-repl"  # a layout's name with this suffix ran replicate_params_over_data


@contextlib.contextmanager
def layout_of(name):
    """The storage layout the ranks of layout ``name`` ran (``...-repl``:
    every weight whole over ``data``; else FSDP storage over ``data``),
    for planning in this process."""
    from repro_torch.sharding.specs import SPEC_OPTIONS

    old = SPEC_OPTIONS["replicate_params_over_data"]
    SPEC_OPTIONS["replicate_params_over_data"] = name.endswith(REPL)
    try:
        yield
    finally:
        SPEC_OPTIONS["replicate_params_over_data"] = old


def whole_over_data(t, cfg, mesh):
    """The parts of a rank's flat buffer ``t`` (..., N_local) that hold the
    leaves the storage layout keeps whole over ``data`` (all of them in the
    replicated layout): what every data replica holds the same."""
    from repro_torch.sharding import collectives as C

    runs = C.data_layout(cfg, mesh).whole_runs()
    return torch.cat([t[..., a:a + n] for a, n in runs], dim=-1)


# ---------------------------------------------------------------------------
# Sequence parallelism (tests/test_torch_sequence_parallel.py and its
# spawned ranks)
# ---------------------------------------------------------------------------

SP_GEN = 4
# The MoE cases of the sequence-parallel tests: reduced, with
# ``router_aux_coef`` 0.5 as ``tests/test_torch_tp_moe.py``'s; expert-parallel
# qwen2-moe-a2.7b, the same with a shared expert of 129 (its d_ff does not
# split over model, so it is held whole), and qwen3-moe-235b-a22b (no shared
# expert).
SP_MOE = {"moe": ("qwen2-moe-a2.7b", {}),
          "moe-whole-shared": ("qwen2-moe-a2.7b", {"shared_expert_ff": 129}),
          "qwen3-moe": ("qwen3-moe-235b-a22b", {})}


def sp_config(case, reduce=reduced, get=get_config):
    """A case of the sequence-parallel tests: ``dense`` (:func:`config`'s
    stablelm-1.6b), an MoE of :data:`SP_MOE` or an arch of :data:`ARCHS`
    (:func:`arch_config`); ``reduce`` / ``get`` of the reference give its
    twin."""
    if case == "dense":
        return reduce(get("stablelm-1.6b"), d_model=64)
    if case in SP_MOE:
        arch, upd = SP_MOE[case]
        return dataclasses.replace(reduce(get(arch)), router_aux_coef=0.5, **upd)
    return arch_config(case, reduce, get)


# ---------------------------------------------------------------------------
# The seq_shard_cache decode layout (tests/test_torch_seq_shard_cache.py and
# its spawned ranks)
# ---------------------------------------------------------------------------

# name: (arch, (data, model), batch, prompt, greedy steps).  "kv1" is
# :func:`config`'s stablelm-1.6b with one kv head; recurrentgemma-9b and
# whisper-large-v3 are :func:`arch_config`'s, gemma2-27b is reduced at
# d_model 64 (4 heads of 64, all kv heads; local layers of window 64, global
# layers, softcap 50).  The recurrentgemma prompts run past its window of
# 64 (the ring wraps); kv1's full cache of 6 + 10 puts slots 8-15 on rank
# 1, empty for the first two steps; the "-odd" capacities (7 + 8 = 15,
# 71 + 8 = 79) do not split over 2, so those leaves stay whole (gemma2's
# local rings of 64 still split).
SSC_CASES = {
    "rg-1x2": ("recurrentgemma-9b", (1, 2), 2, 80, 8),
    "rg-1x4": ("recurrentgemma-9b", (1, 4), 2, 80, 8),
    "kv1-1x2": ("kv1", (1, 2), 2, 6, 10),
    "kv1-odd-1x2": ("kv1", (1, 2), 2, 7, 8),
    "gemma2-2x1": ("gemma2-27b", (2, 1), 1, 72, 8),
    "gemma2-odd-2x1": ("gemma2-27b", (2, 1), 1, 71, 8),
    "gemma2-2x2": ("gemma2-27b", (2, 2), 1, 72, 8),
    "whisper-2x1": ("whisper-large-v3", (2, 1), 1, 16, 8),
}


def ssc_config(arch, reduce=reduced, get=get_config):
    """A :data:`SSC_CASES` arch; ``reduce`` / ``get`` of the reference give
    its twin."""
    if arch == "kv1":
        return dataclasses.replace(reduce(get("stablelm-1.6b"), d_model=64), num_kv_heads=1)
    if arch in ARCH_UPDATES:
        return arch_config(arch, reduce, get)
    return reduce(get(arch), d_model=64)


def ssc_capacity(cfg, prompt, gen):
    """The positions ``launch.serve.serve``'s cache holds: the prompt (a
    vlm's prefix and tokens) and the steps."""
    n_pre = cfg.num_prefix_embeddings if cfg.frontend == "vision" else 0
    return n_pre + prompt + gen


def serve_cache(cfg, params, batch, gen):
    """``launch.serve.serve``'s prefill (whisper: its cache from the
    encoder) and ``gen`` greedy steps, through the model's entry points
    inside ``collectives.serving`` -> the decode cache after them (under a
    running mesh, the rank's)."""
    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as C
    from repro_torch.training import make_serve_step

    B, S = batch["tokens"].shape
    cap = ssc_capacity(cfg, S, gen)
    frames = batch["enc_embeds"].shape[1] if cfg.is_encoder_decoder else None
    with C.serving(B, cap, frames), torch.no_grad():
        mesh = C.sharded_mesh()
        rows = batch if mesh is None else C.local_rows(batch, mesh, strict=False)
        if cfg.is_encoder_decoder:
            cache = M.init_decode_state(params, cfg, rows["tokens"].shape[0], cap,
                                        cache_dtype=torch.float32, batch=rows)
            last, start = rows["tokens"][:, 0].to(torch.int32), 0
        else:
            logits, cache = M.prefill(params, rows, cfg, cap, cache_dtype=torch.float32)
            last = C.greedy_argmax(logits, C.vocab_mesh(cfg)).to(torch.int32)
            start = cap - gen
        step = make_serve_step(cfg)
        for i in range(gen):
            last = step(params, cache, last, torch.tensor(start + i))["next_token"]
    return cache
