"""The H100 planner (``repro_torch.launch.{input_specs,analysis,dryrun}``)
against the reference's TPU dry-run modules where the two mean the same,
and against hand counts where they cannot.

* ``input_specs``: every leaf's path, shape and dtype equal to the
  reference's ``jax.eval_shape`` stand-ins, for all 40 (arch x shape)
  combinations (a TrainState's ``rng`` is a ``torch.Generator`` in the port
  and a key in the reference: both hold it at ``0/rng``, and it is left out
  of the comparison);
* ``model_flops``: equal to the reference's, every arch and shape;
* ``roofline_terms``: the dominant term on hand cases at the H100 figures;
* ``collective_bytes``: hand counts on a tiny config;
* the depth extrapolation: exact on a linear toy and on a reduced model;
* the CLI: a ``--small_mesh`` run writes a record with ``status: ok``, and
  the skips are the reference's six.
"""

import ast
import dataclasses
import json
import os

import jax
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import analysis as JA
from repro.launch import input_specs as JI
from repro.sharding.specs import _path_str
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, reduced
from repro_torch.launch import analysis as TA
from repro_torch.launch import dryrun as TD
from repro_torch.launch import input_specs as TI
from repro_torch.launch.mesh import HARDWARE, make_mesh
from repro_torch.sharding.specs import leaf_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dt(d) -> str:
    return str(d).split(".")[-1]


def test_input_shapes_and_archs_are_the_reference_s():
    assert INPUT_SHAPES == J_SHAPES
    assert tuple(ASSIGNED_ARCHS) == tuple(J_ARCHS)


@pytest.mark.parametrize("arch", list(ASSIGNED_ARCHS))
def test_input_specs_match_reference(arch):
    for shape in INPUT_SHAPES:
        jtree = JI.input_specs(arch, shape)
        want = [(_path_str(p), tuple(s.shape), _dt(s.dtype))
                for p, s in jax.tree_util.tree_flatten_with_path(jtree)[0]]
        got = [(p, tuple(t.shape), _dt(t.dtype)) if isinstance(t, torch.Tensor) else (p, None, None)
               for p, t in leaf_paths(TI.input_specs(arch, shape))]
        if INPUT_SHAPES[shape][2] == "train":
            assert [w for w in want if w[0] == "0/rng"] and [g for g in got if g[0] == "0/rng"]
            want = [w for w in want if w[0] != "0/rng"]
            got = [g for g in got if g[0] != "0/rng"]
        assert got == want, (shape, [(g, w) for g, w in zip(got, want) if g != w][:4])
        assert all(t.device.type == "meta" for _, t in leaf_paths(TI.input_specs(arch, shape))
                   if isinstance(t, torch.Tensor))


def test_ring_workers_and_model_flops_match_reference():
    for arch in ASSIGNED_ARCHS:
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        assert TI.ring_size_for(tcfg) == JI.ring_size_for(jcfg)
        assert TI.workers_for(tcfg) == JI.workers_for(jcfg)
        for shape, (seq, batch, kind) in INPUT_SHAPES.items():
            assert TA.model_flops(tcfg, batch=batch, seq=seq, kind=kind) == \
                JA.model_flops(jcfg, batch=batch, seq=seq, kind=kind)


def test_roofline_terms_pick_the_dominant_term():
    """At the H100 figures: 989e12 FLOP/s bf16, 3.35e12 B/s, 18 x 25e9 B/s."""
    t = TA.roofline_terms(989e12, 3.35e12 / 2, 450e9 / 4, num_chips=1)
    assert t["dominant"] == "compute"
    assert t["t_compute_s"] == pytest.approx(1.0) and t["t_memory_s"] == pytest.approx(0.5)
    assert t["t_collective_s"] == pytest.approx(0.25)
    assert TA.roofline_terms(1e12, 3.35e12, 0, num_chips=1)["dominant"] == "memory"
    assert TA.roofline_terms(1e12, 1e9, 450e9 * 2, num_chips=1)["dominant"] == "collective"
    # global counts over 4 cards; the f32 peak
    t = TA.roofline_terms(4 * 67e12, 0, 0, num_chips=4, per_device=False,
                          peak_flops=TA.peak_flops_for("float32"))
    assert t["t_compute_s"] == pytest.approx(1.0) and t["dominant"] == "compute"
    assert HARDWARE["hbm_bytes"] == 80e9


def _tiny(**upd):
    """One dense layer: d 8, 2 heads of 4, d_ff 16, vocab 32."""
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b")), num_layers=1, d_model=8,
                              num_heads=2, num_kv_heads=2, head_dim=4, d_ff=16, vocab_size=32)
    return dataclasses.replace(cfg, **upd)


def test_collective_bytes_hand_counts():
    cfg = _tiny()
    act = torch.empty((), dtype=getattr(torch, cfg.activation_dtype)).element_size()
    # one card: nothing moves
    one = TA.collective_bytes(cfg, "train", 4, 16, make_mesh((1, 1), ("data", "model")))
    assert one["total"] == 0
    # model 2: wo and w_down are row-parallel, one all-reduce each of (B, S, D),
    # ring 2 (n - 1) / n = 1 per byte, doubled for the backward
    m2 = TA.collective_bytes(cfg, "train", 4, 16, make_mesh((1, 2), ("data", "model")))
    assert m2["all-reduce"] == 2 * 2 * (4 * 16 * 8 * act)
    assert m2["all-gather"] == m2["reduce-scatter"] == 0
    # decode: S = 1, no backward
    d2 = TA.collective_bytes(cfg, "decode", 4, 16, make_mesh((1, 2), ("data", "model")))
    assert d2["all-reduce"] == 2 * (4 * 1 * 8 * act)
    # data 2: every data-sharded weight gathered once ((n - 1) / n = 1/2 of its
    # model-local size), and its gradient reduce-scattered when training
    from repro_torch.models import model as M
    from repro_torch.sharding.specs import param_spec_for

    mesh = make_mesh((2, 1), ("data", "model"))
    want = sum(t.numel() * t.element_size() / 2 for p, t in leaf_paths(M.init_model(None, cfg, "meta"))
               if any(e not in (None, "model") for e in param_spec_for(p, tuple(t.shape), mesh)))
    assert want > 0
    g2 = TA.collective_bytes(cfg, "train", 4, 16, mesh)
    assert g2["all-gather"] == g2["reduce-scatter"] == want and g2["all-reduce"] == 0
    assert g2["total"] == 2 * want


def test_collective_bytes_of_the_weights_stationary_moe():
    cfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")), num_layers=1,
                              moe_weights_stationary=True)
    mesh = make_mesh((2, 2), ("data", "model"))
    ws = TA.collective_bytes(cfg, "decode", 4, 16, mesh)
    ep = TA.collective_bytes(dataclasses.replace(cfg, moe_weights_stationary=False), "decode",
                             4, 16, mesh)
    act = 2 * 1 * cfg.d_model * torch.empty((), dtype=getattr(torch, cfg.activation_dtype)) \
        .element_size()  # B_loc 2, S 1
    # ep: combine over model 2 (1 per byte); ws: gather over data 2 (1 per byte)
    # of (n_data, T_loc, D), combine over 4 ranks (1.5 per byte) of the same
    assert ws["all-reduce"] - ep["all-reduce"] == pytest.approx(2 * act + 1.5 * 2 * act - act)


def test_depth_extrapolation_is_exact_on_a_linear_toy():
    @dataclasses.dataclass(frozen=True)
    class Toy:
        num_layers: int = 7
        pattern_period: int = 1
        is_encoder_decoder: bool = False

    def build(cfg):
        ws = [torch.empty(16, 16, device="meta") for _ in range(cfg.num_layers)]
        x = torch.empty(4, 16, device="meta")

        def step(x, ws):
            for w in ws:
                x = torch.tanh(x @ w)
            return x @ torch.empty(16, 3, device="meta")

        return step, (x, ws)

    got = TD.plan_extrapolated(Toy(), build)
    step, args = build(Toy())
    want = TD.measure_step(step, args)
    assert got["flops"] == want["flops"] == 7 * 2 * 4 * 16 * 16 + 2 * 4 * 16 * 3
    assert got["hbm_bytes"] == want["hbm_bytes"]
    assert got["peak_bytes"] == want["peak_bytes"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_depth_extrapolation_is_exact_on_a_reduced_model(shape):
    """FLOPs, bytes and peak of a 6-layer reduced stablelm, extrapolated from
    2 and 3 layers, equal the 6-layer run's (at a small batch and sequence)."""
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), d_model=64), num_layers=6)
    seq = {"train_4k": 32, "prefill_32k": 64}[shape]

    def build(c):
        shapes = dict(INPUT_SHAPES)
        INPUT_SHAPES[shape] = (seq, 2, shapes[shape][2])
        try:
            c = TD._serving(c, INPUT_SHAPES[shape][2])
            return TI.step_for_cfg(c, shape), TI.specs_for_cfg(c, shape)
        finally:
            INPUT_SHAPES.update(shapes)

    got = TD.plan_extrapolated(cfg, build)
    with TD.planning_kernels() as mapping:
        want = TD.measure_step(*build(cfg), flop_mapping=mapping)
    for k in ("flops", "hbm_bytes", "peak_bytes"):
        assert got[k] == want[k], k


def test_flash_flops_count_the_band():
    """The planning flash op counts 4 H per (query, key) pair in the band."""
    assert TD.band_pairs(4, 4, True, None) == 10
    assert TD.band_pairs(4, 4, False, None) == 16
    assert TD.band_pairs(5, 5, True, 2) == 9
    q = torch.empty(2, 4, 3, 8, device="meta")
    k = torch.empty(2, 4, 3, 8, device="meta")
    with TD.planning_kernels() as mapping:
        from repro_torch.models import attention as A

        got = TD.measure_step(lambda q, k: A.flash_attention(q, k, k, causal=True, window=2),
                              (q, k), flop_mapping=mapping)
    assert got["flops"] == 2 * 3 * TD.band_pairs(4, 4, True, 2) * 4 * 8


def _reference_skips() -> dict:
    src = open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")).read()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "SKIPS":
            return ast.literal_eval(node.value)
    raise AssertionError("no SKIPS in the reference's dryrun.py")


def test_cli_small_mesh_writes_an_ok_record_and_the_reference_skips(tmp_path, capsys):
    assert TD.SKIPS == _reference_skips()
    assert TD.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--small_mesh",
                    "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "stablelm-1_6b_decode_32k_small.json").read_text())
    assert rec["status"] == "ok" and rec["num_chips"] == 4 and rec["mesh"] == [2, 2]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["hbm_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["argument_bytes"] < rec["memory"]["argument_bytes_total"]
    # 24 layers x 128 x 32768 x 32 x 64 x (k, v) bf16: 824.6 GB of cache over 4 cards
    assert rec["memory"]["fits"] is (rec["memory"]["peak_bytes_per_card"] <= 80e9) is False
    assert TD.main(["--arch", "stablelm-1.6b", "--shape", "long_500k", "--cards", "1",
                    "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "stablelm-1_6b_long_500k_card1.json").read_text())
    assert rec["status"] == "skip" and rec["reason"] == TD.SKIPS[("stablelm-1.6b", "long_500k")]
    assert "[skip]" in capsys.readouterr().out


def test_argument_bytes_split_over_the_layout():
    """On one card the argument bytes are the leaves' nbytes; on model 4 the
    sharded leaves divide by 4."""
    args = TI.input_specs("stablelm-1.6b", "decode_32k")
    total = sum(t.numel() * t.element_size() for _, t in leaf_paths(args))
    one, tot = TD.argument_bytes(args, make_mesh((1, 1), ("data", "model")), 128)
    assert one == tot == total
    four, _ = TD.argument_bytes(args, make_mesh((1, 4), ("data", "model")), 128)
    assert total / 4 <= four < total


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaf_paths(tree)
               if isinstance(t, torch.Tensor))


def test_planned_state_bytes_equal_the_built_state():
    """What ``chip_smoke.py`` phase 12 gates on the card, here on the CPU at
    reduced width: the planned state bytes of an async fused run (bf16 ring)
    and of a sharded one equal the bytes of the state ``run`` builds, and a
    planned serve's equal the params and the cache ``prefill`` returns."""
    from repro_torch.core.staleness import Geometric, Poisson
    from repro_torch.data import make_batch_for
    from repro_torch.models import model as M
    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec, run
    from repro_torch.training import default_adapt_setup, init_params, make_worker_adapt

    cfg = reduced(get_config("stablelm-1.6b"), d_model=64)
    sched, _, adapt = default_adapt_setup(0.01, 4, 4, device="cpu")
    link = T.scale_by_staleness(sched, 0.01, m=4, tau_max=adapt.tau_max)
    pipe = T.chain(link, T.scale(-0.01), T.trace(0.9))
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=2, batch_size=2, seq_len=16,
                   num_workers=4, ring=4, ring_dtype="bfloat16", adapt=adapt, fuse=True, seed=0,
                   device="cpu")
    rec = TD.plan_run(spec)
    assert rec["memory"]["argument_bytes"] == _nbytes(run(spec).state)
    assert rec["cost"]["flops"] > 0 and rec["kind"] == "train"

    wadapt = make_worker_adapt(sched.table[:adapt.tau_max + 1], [Geometric(0.3), Poisson(2.0)],
                               cdf_support=4, device="cpu")
    spec = RunSpec(cfg=cfg, pipeline=T.chain(T.scale_by_staleness(sched, 0.01), T.scale(-0.01),
                                             T.trace(0.9)),
                   mode="sharded_async", num_steps=2, batch_size=2, seq_len=16, ring=4,
                   ring_dtype="bfloat16", adapt=wadapt, fuse=True, seed=0, device="cpu")
    assert TD.plan_run(spec)["memory"]["argument_bytes"] == _nbytes(run(spec).state)

    mcfg = reduced(get_config("qwen2-moe-a2.7b"), d_model=64)
    rec = TD.plan_serve(mcfg, batch=2, prompt=16, gen=4)
    params = init_params(0, mcfg, "cpu")
    _, cache = M.prefill(params, make_batch_for(mcfg, batch=2, seq=16, seed=0), mcfg, 20,
                         cache_dtype=torch.float32)
    assert rec["memory"]["argument_bytes"] == _nbytes(params) + _nbytes(cache)


def test_optimizer_stand_ins_plan_in_place():
    """The fused tick planned on shape-only tensors allocates no temporary
    of the ring's size: its peak is the state plus the step's activations,
    below the state plus one f32 copy of the ring."""
    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec
    from repro_torch.training import default_adapt_setup

    cfg = reduced(get_config("stablelm-1.6b"), d_model=64)
    sched, _, adapt = default_adapt_setup(0.01, 4, 8, device="cpu")
    pipe = T.chain(T.scale_by_staleness(sched, 0.01), T.scale(-0.01), T.trace(0.9))
    spec = RunSpec(cfg=cfg, pipeline=pipe, mode="async", batch_size=2, seq_len=16,
                   num_workers=4, ring=8, ring_dtype="bfloat16", adapt=adapt, fuse=True,
                   device="cpu")
    rec = TD.plan_run(spec)
    n = cfg.param_count()
    assert rec["memory"]["peak_bytes"] < rec["memory"]["argument_bytes"] + 8 * n * 4
