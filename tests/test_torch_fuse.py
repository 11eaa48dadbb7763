"""The port's fusion contract, inside the port: ``make_step(..., fuse=True)``
trajectories are BITWISE equal (f32, CPU) to the link-by-link pipeline for
the sgd / momentum / adam bodies in sync and async mode — the port's version
of ``tests/test_fuse.py:323-378``.  The fused step runs the kernel wrappers'
plain versions here (CPU tensors), in place on a flat-native param buffer and
a flat ring; the unfused step runs per-leaf rings and the linked chain.  The
clip variant matches to f32 round-off only (its norm runs over the flat
buffer instead of leaf by leaf): 1e-6.
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.staleness import Poisson
from repro_torch.core.step_size import make_schedule
from repro_torch.data import lm_batches
from repro_torch.optim import transform as T
from repro_torch.optim.fuse import plan_fusion
from repro_torch.training import init_params, init_train_state, make_adapt, make_step, param_view
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def small_cfg():
    return reduced(get_config("stablelm-1.6b"), d_model=128)


def _sched(alpha_c=0.05):
    return make_schedule("poisson_momentum", alpha_c, Poisson(4.0), K=alpha_c, tau_max=31)


def _chains(sched, lr=0.05, with_staleness=True):
    prefix = (T.scale_by_staleness(sched, lr),) if with_staleness else ()
    return {
        "sgd": T.chain(*prefix, T.scale(-lr)),
        "momentum": T.chain(*prefix, T.scale(-lr), T.trace(0.9)),
        "adam": T.chain(*prefix, T.scale_by_adam(), T.scale(-lr)),
    }


def _flat(params, cfg):
    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(param_view(params, cfg))])


def _trajectory(cfg, pipe, *, mode, fuse, steps=3, ring_dtype=None):
    params = init_params(0, cfg, "cpu")
    adapt = make_adapt(_sched(), Poisson(4.0), cdf_support=8, tau_max=31) if mode == "async" else None
    state = init_train_state(cfg, pipe, seed=0, device="cpu", params=params, fuse=fuse,
                             async_ring=8 if mode == "async" else 0, adapt=adapt,
                             ring_dtype=ring_dtype)
    step = make_step(cfg, pipe, mode=mode, num_workers=4, fuse=fuse)
    losses = []
    for batch, _ in zip(lm_batches(cfg.vocab_size, 2, 16, seed=0), range(steps)):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    return _flat(state.params, cfg), losses, state


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_fused_trajectory_bitwise_equals_unfused(small_cfg, mode, kind):
    with_staleness = mode == "async"
    pu, lu, su = _trajectory(small_cfg, _chains(_sched(), with_staleness=with_staleness)[kind],
                             mode=mode, fuse=False)
    pf, lf, sf = _trajectory(small_cfg, _chains(_sched(), with_staleness=with_staleness)[kind],
                             mode=mode, fuse=True)
    assert isinstance(sf.params, torch.Tensor) and sf.params.dim() == 1  # flat-native
    assert lu == lf
    assert torch.equal(pu, pf), f"{mode}/{kind}: max diff {(pu - pf).abs().max().item()}"
    if mode == "async":
        assert isinstance(sf.delayed.ring, torch.Tensor) and sf.delayed.ring.dim() == 2
        assert torch.equal(su.adapt.hist, sf.adapt.hist)
        assert int(sf.delayed.step) == 3


def test_fused_apply_link_fuses_to_momentum_bitwise(small_cfg):
    """``chain(staleness, fused_apply)`` unfused runs the fused_update wrapper;
    fused it lowers to the momentum tick — the same numbers bit for bit."""
    pipe = lambda: T.chain(T.scale_by_staleness(_sched(), 0.05), T.fused_apply(0.05, 0.9))  # noqa: E731
    pu, lu, _ = _trajectory(small_cfg, pipe(), mode="async", fuse=False)
    pf, lf, _ = _trajectory(small_cfg, pipe(), mode="async", fuse=True)
    assert lu == lf and torch.equal(pu, pf)


def test_clip_variant_matches_to_roundoff(small_cfg):
    pipe = lambda: T.chain(T.scale_by_staleness(_sched(), 0.05), T.clip_by_global_norm(0.5),  # noqa: E731
                           T.scale(-0.05), T.trace(0.9))
    pu, lu, _ = _trajectory(small_cfg, pipe(), mode="async", fuse=False)
    pf, lf, _ = _trajectory(small_cfg, pipe(), mode="async", fuse=True)
    np.testing.assert_allclose(pf.numpy(), pu.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lf, lu, rtol=1e-6)


def test_bf16_ring_fused_equals_unfused(small_cfg):
    pu, lu, su = _trajectory(small_cfg, _chains(_sched())["momentum"], mode="async", fuse=False,
                             ring_dtype="bfloat16")
    pf, lf, sf = _trajectory(small_cfg, _chains(_sched())["momentum"], mode="async", fuse=True,
                             ring_dtype="bfloat16")
    assert sf.delayed.ring.dtype == torch.bfloat16
    assert lu == lf and torch.equal(pu, pf)


def test_plan_fusion_classifies_like_reference():
    s = _sched()
    plans = {k: plan_fusion(p) for k, p in _chains(s).items()}
    assert {k: p.kind for k, p in plans.items()} == {"sgd": "sgd", "momentum": "momentum", "adam": "adam"}
    assert plans["momentum"].mu == 0.9 and plans["momentum"].scale == -0.05
    assert plans["sgd"].staleness is not None
    clip = plan_fusion(T.chain(T.scale_by_staleness(s, 0.05), T.clip_by_global_norm(1.0), T.scale(-0.1)))
    assert clip.kind == "sgd" and clip.clip == 1.0
    assert plan_fusion(T.chain(T.scale(-0.1), T.GradientTransform(
        init=lambda p: (), update=lambda u, s_, p, c: (u, s_), kind="custom"))) is None


def test_unfuseable_chain_falls_back_with_one_warning(small_cfg):
    custom = T.GradientTransform(init=lambda p: (), update=lambda u, s, p, c: (u, s), kind="custom")
    pipe = T.chain(T.scale(-0.05), custom)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        make_step(small_cfg, pipe, mode="sync", fuse=True)
    assert len([w for w in caught if "not fuseable" in str(w.message)]) == 1


def test_async_rejects_misordered_chain(small_cfg):
    pipe = T.chain(T.scale(-0.05), T.scale_by_staleness(_sched(), 0.05))
    with pytest.raises(AssertionError, match="put the staleness/drop links first"):
        make_step(small_cfg, pipe, mode="async", num_workers=4)
