"""The planner's multi-card records are the port's own layout for every
registered arch.

``repro_torch.launch.dryrun --cards 4`` (data 1 x model 4): a stablelm-1.6b
record's and a falcon-mamba-7b record's ``layout`` reads as the port's and
the collective term is ``port_collective_bytes`` (the all-reduces a port
rank runs, no FSDP all-gather at data 1); a ``sequence_parallel`` config
plans its gathers and reduce-scatters over ``model`` in place of the
all-reduces they replace, with the params of the layout without it.  On
``--small_mesh`` (data 2 x model 2) a
stablelm-1.6b rank holds its FSDP block over ``data`` of a ``--cards 2``
rank's params, and with ``--repl_params`` (every weight whole over
``data``) the params of a ``--cards 2`` rank.
"""

import dataclasses
import json
import math

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.analysis import port_collective_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.specs import local_template
from repro_torch.training.steps import param_template
from repro_torch.tree import tree_leaves
from torch_tp_common import REPL, layout_of


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("plan")
    for arch in ("stablelm-1.6b", "falcon-mamba-7b"):
        assert D.main(["--arch", arch, "--shape", "decode_32k", "--cards", "4",
                       "--out", str(out)]) == 0
    return {arch: json.load(open(out / f"{arch.replace('.', '_')}_decode_32k_card4.json"))
            for arch in ("stablelm-1.6b", "falcon-mamba-7b")}


def test_a_sharded_arch_plans_the_port_layout(records):
    rec = records["stablelm-1.6b"]
    assert rec["status"] == "ok" and rec["num_chips"] == 4
    assert rec["layout"].startswith("the port's layout")
    want = port_collective_bytes(get_config("stablelm-1.6b"), "decode", 128, 32_768,
                                 make_mesh((1, 4), ("data", "model")))
    assert rec["collectives"]["counted"] == want["counted"]
    assert rec["collectives"]["all-gather"] == rec["collectives"]["reduce-scatter"] == 0
    assert rec["collectives"]["total"] == pytest.approx(want["total"])


def test_an_ssm_arch_plans_the_port_layout(records):
    """falcon-mamba-7b, which the port did not shard before its Mamba layer
    did, now plans the port's layout: its collective term is the port's
    count, the Mamba layers' partial sums and outputs among it."""
    rec = records["falcon-mamba-7b"]
    assert rec["status"] == "ok"
    assert rec["layout"].startswith("the port's layout")
    want = port_collective_bytes(get_config("falcon-mamba-7b"), "decode", 128, 32_768,
                                 make_mesh((1, 4), ("data", "model")))
    assert rec["collectives"]["counted"] == want["counted"]
    assert want["counted"]["ssm_proj"] > 0 and want["counted"]["ssm_out"] > 0
    assert rec["collectives"]["all-gather"] == rec["collectives"]["reduce-scatter"] == 0
    assert rec["collectives"]["total"] == pytest.approx(want["total"])


# the leaf of the layer an arch adds to the port's tensor parallelism, and
# whether model 2 splits it (internvl2-2b's odd vocab keeps its embedding whole)
_LAYER_LEAVES = {"SSM": ("stack/pos0/ssm/in_proj", True),
                 "RG-LRU": ("stack/pos0/rglru/w_a", True),
                 "encoder": ("decoder/cross_attn/wk", True),
                 "vision": ("embed/embedding", False)}


@pytest.mark.parametrize("arch,why", [("stablelm-1.6b", None), ("qwen2-moe-a2.7b", None),
                                      ("gemma2-27b", None), ("codeqwen1.5-7b", None),
                                      ("falcon-mamba-7b", "SSM"), ("recurrentgemma-9b", "RG-LRU"),
                                      ("whisper-large-v3", "encoder"),
                                      ("internvl2-2b", "vision"),
                                      ("stablelm-1.6b", "sequence_parallel")])
def test_which_archs_the_port_shards(arch, why):
    """Every registered arch shards: a model-2 rank holds blocks of its
    params.  ``why`` names the layer of the arch the port shards since its
    later slice, whose leaf a model-2 rank then holds as its block.  A
    ``sequence_parallel`` config shards as the config without it: the
    layout is the activations', not the params'."""
    from repro_torch.training.steps import param_template
    from repro_torch.tree import tree_paths

    def shapes(template):
        return {"/".join(p): tuple(s) for p, (s, _) in tree_paths(template)}

    cfg = get_config(arch)
    two = make_mesh((1, 2), ("data", "model"))
    if why == "sequence_parallel":
        sp = dataclasses.replace(cfg, sequence_parallel=True)
        assert shapes(local_template(sp, two)) == shapes(local_template(cfg, two))
        return
    assert shapes(local_template(cfg, two)) != shapes(param_template(cfg))
    if why is not None:
        path, split = _LAYER_LEAVES[why]
        whole = shapes(param_template(cfg))[path]
        rank = shapes(local_template(cfg, make_mesh((1, 2), ("data", "model"))))[path]
        assert (rank != whole) == split


def test_the_planner_refuses_a_layout_the_port_does_not_run():
    """The layouts it refused before the port ran them now plan: a
    ``sequence_parallel`` config (``--set sequence_parallel=true``) in the
    record of an input shape on 4 cards and on the small mesh, and in
    ``plan_run``; its collective term is the port's count, the sequence
    gathered and reduce-scattered over ``model`` and no ``attn`` / ``mlp``
    all-reduce, a decode step as without it; its params those of the config
    without it."""
    from repro_torch.configs import reduced
    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec

    sp = {"sequence_parallel": True}
    base = D.dryrun_extrapolated("stablelm-1.6b", "prefill_32k", cards=4)
    for kw in ({"cards": 4}, {"small_mesh": True}):
        rec = D.dryrun_extrapolated("stablelm-1.6b", "prefill_32k", overrides=sp, **kw)
        mesh = make_mesh((2, 2) if kw.get("small_mesh") else (1, 4), ("data", "model"))
        want = port_collective_bytes(dataclasses.replace(get_config("stablelm-1.6b"), **sp),
                                     "prefill", 32, 32_768, mesh)["counted"]
        assert rec["status"] == "ok" and rec["collectives"]["counted"] == want
        assert want["sp_gather"] > 0 and want["sp_scatter"] > 0
        assert want["attn"] == want["mlp"] == 0
    assert rec["memory"]["argument_bytes"] == D.dryrun_extrapolated(
        "stablelm-1.6b", "prefill_32k", small_mesh=True)["memory"]["argument_bytes"]
    assert base["collectives"]["counted"]["sp_gather"] == 0
    dec = D.dryrun_extrapolated("stablelm-1.6b", "decode_32k", cards=4, overrides=sp)
    assert dec["collectives"]["counted"]["sp_gather"] == 0
    spec = RunSpec(cfg=dataclasses.replace(reduced(get_config("stablelm-1.6b"), d_model=64), **sp),
                   pipeline=T.chain(T.scale(-0.05)), mode="sync", num_steps=1, batch_size=2,
                   seq_len=16, device="cpu")
    rec = D.plan_run(spec, mesh=make_mesh((1, 2), ("data", "model")))
    assert rec["collectives"]["counted"]["sp_scatter"] > 0


@pytest.mark.parametrize("name", ["2x2-repl", "2x2"])
def test_small_mesh_keeps_weights_whole_over_data(name):
    """Replicated over data (``--repl_params``), a data 2 x model 2 rank
    holds a model-2 rank's params; in the FSDP storage (the default) its
    block over data of them, gathered a layer at a time when it serves."""
    cfg = get_config("stablelm-1.6b")
    small = make_mesh((2, 2), ("data", "model"))
    two = make_mesh((1, 2), ("data", "model"))
    with layout_of(name):
        small_t = [s for s, _ in tree_leaves(local_template(cfg, small))]
        two_t = [s for s, _ in tree_leaves(local_template(cfg, two))]
        rec = D.dryrun_extrapolated("stablelm-1.6b", "prefill_32k", small_mesh=True)
    params = sum(4 * math.prod(s) for s in small_t)
    # + its rows of the int32 tokens and labels (32 x 32768 over data 2)
    assert rec["memory"]["argument_bytes"] == params + 2 * 32 * 32_768 * 4 // 2
    assert rec["collectives"]["counted"]["grad"] == 0  # serving: no gradient
    if name.endswith(REPL):
        assert small_t == two_t and rec["collectives"]["counted"]["fsdp_gather"] == 0
        assert rec["layout"].endswith("every weight whole over data")
    else:
        whole = sum(4 * math.prod(s) for s in two_t)
        assert whole // 2 < params < whole // 2 + whole // 100  # the norms stay whole
        # one prefill gathers every leaf split over data once, whole over data
        assert rec["collectives"]["counted"]["fsdp_gather"] == \
            sum(4 * math.prod(t) for t, s in zip(two_t, small_t) if s != t)
        assert "FSDP" in rec["layout"]


def test_plan_run_on_a_layout_holds_the_rank_state():
    """``plan_run(spec, mesh)``: the state of a rank holds N_local-long flat
    buffers, model 2 about half of one card's."""
    from repro_torch.configs import reduced
    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec
    from repro_torch.training import default_adapt_setup

    cfg = reduced(get_config("stablelm-1.6b"), d_model=64)
    sched, _, adapt = default_adapt_setup(0.05, 4, 4, device="cpu")
    pipe = T.chain(T.scale_by_staleness(sched, 0.05, m=4, tau_max=adapt.tau_max), T.scale(-0.05),
                   T.trace(0.9))
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=1, batch_size=2, seq_len=16,
                   num_workers=4, ring=4, adapt=adapt, fuse=True, device="cpu")
    one = D.plan_run(spec)
    rank = D.plan_run(spec, mesh=make_mesh((1, 2), ("data", "model")))
    whole = sum(math.prod(s) for s, _ in tree_leaves(param_template(cfg)))
    n = sum(math.prod(s) for s, _ in tree_leaves(local_template(
        cfg, make_mesh((1, 2), ("data", "model")))))
    assert n < whole
    # params f32 + momentum f32 + a ring of 4 f32 slots, and the replicated small tables
    small = one["memory"]["argument_bytes"] - 6 * 4 * whole
    assert 0 < small < 4 * whole // 100
    assert rank["memory"]["argument_bytes"] == 6 * 4 * n + small
    assert rank["layout"].startswith("the port's layout")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
                                  "gemma2-27b", "codeqwen1.5-7b", "gemma3-27b",
                                  "falcon-mamba-7b", "recurrentgemma-9b", "whisper-large-v3",
                                  "internvl2-2b"])
def test_every_arch_plans_with_set_flags(arch, tmp_path):
    """``--small_mesh --set sequence_parallel=true --set
    moe_weights_stationary=true`` (the reference's ``--set``) plans every
    arch, its record naming the overrides and its collective term the
    port's count under them."""
    from repro_torch.configs import ASSIGNED_ARCHS

    assert arch in ASSIGNED_ARCHS
    sets = ["--set", "sequence_parallel=true", "--set", "moe_weights_stationary=true"]
    assert D.main(["--arch", arch, "--shape", "prefill_32k", "--small_mesh", *sets,
                   "--out", str(tmp_path)]) == 0
    tag = f"{arch}_prefill_32k_small_moe_weights_stationary_sequence_parallel"
    rec = json.load(open(tmp_path / (tag.replace(".", "_") + ".json")))
    flags = {"sequence_parallel": True, "moe_weights_stationary": True}
    assert rec["status"] == "ok" and rec["overrides"] == flags
    cfg = dataclasses.replace(get_config(arch), use_pallas=True, **flags)
    want = port_collective_bytes(cfg, "prefill", 32, 32_768, make_mesh((2, 2), ("data", "model")))
    assert rec["collectives"]["counted"] == want["counted"]
    assert (want["counted"]["sp_gather"] > 0) == (not cfg.is_encoder_decoder)
    assert (want["counted"]["gather"] > 0) == bool(cfg.num_experts)
