"""The planner's multi-card records are the port's own layout for the archs
the port shards, and still the reference's for the rest.

``repro_torch.launch.dryrun --cards 4`` (data 1 x model 4): a stablelm-1.6b
record's ``layout`` reads as the port's and its collective term is
``port_collective_bytes`` (the all-reduces a port rank runs, no FSDP
all-gather); a falcon-mamba-7b record (an SSM, which the port does not shard
and raises on under ``model`` > 1) still says it is the reference's layout.
On ``--small_mesh`` (data 2 x model 2) the port keeps every weight whole over
``data``, so a stablelm-1.6b rank holds the params of a ``--cards 2`` rank.
"""

import json
import math

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.analysis import port_collective_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.specs import local_template, tensor_parallel_unsupported
from repro_torch.training.steps import param_template
from repro_torch.tree import tree_leaves


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


def test_an_unsharded_arch_still_plans_the_reference_layout(records):
    rec = records["falcon-mamba-7b"]
    assert rec["status"] == "ok"
    assert rec["layout"].startswith("the reference's tensor-parallel layout, not run")
    assert "Mamba" in rec["layout"]
    assert "counted" not in rec["collectives"]


@pytest.mark.parametrize("arch,why", [("stablelm-1.6b", None), ("qwen2-moe-a2.7b", None),
                                      ("gemma2-27b", None), ("codeqwen1.5-7b", None),
                                      ("falcon-mamba-7b", "SSM"), ("recurrentgemma-9b", "RG-LRU"),
                                      ("whisper-large-v3", "encoder"),
                                      ("internvl2-2b", "vision")])
def test_which_archs_the_port_shards(arch, why):
    got = tensor_parallel_unsupported(get_config(arch))
    assert (got is None) if why is None else (why in got)


def test_small_mesh_keeps_weights_whole_over_data():
    cfg = get_config("stablelm-1.6b")
    small = make_mesh((2, 2), ("data", "model"))
    two = make_mesh((1, 2), ("data", "model"))
    assert [s for s, _ in tree_leaves(local_template(cfg, small))] == \
        [s for s, _ in tree_leaves(local_template(cfg, two))]
    rec = D.dryrun_extrapolated("stablelm-1.6b", "prefill_32k", small_mesh=True)
    params = sum(4 * math.prod(s) for s, _ in tree_leaves(local_template(cfg, two)))
    # + its rows of the int32 tokens and labels (32 x 32768 over data 2)
    assert rec["memory"]["argument_bytes"] == params + 2 * 32 * 32_768 * 4 // 2
    assert rec["collectives"]["counted"]["grad"] == 0  # serving: no gradient


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
