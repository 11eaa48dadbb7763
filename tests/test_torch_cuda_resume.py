"""Checkpoint/resume on the card: bitwise, through the hand-written kernels.

This file imports no JAX, so it runs on a machine with a card and PyTorch
alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_resume.py

It skips without a card.  Full-width stablelm-1.6b at 2 layers (d_model 2048,
vocab 100352, a bf16 ring of 8): run A takes 6 ticks with a checkpoint at
step 3 and a refresh every 2, run B (fresh pipeline and adapt) resumes at 3.
B's losses, every leaf of its final state and its host estimator must equal
A's bit for bit, for each path that carries a kernel: the fused async tick
(``fused_tick``), the fused sync chain (``fused_chain``) and the
``fused_apply`` link (``fused_update``).  Each kernel must have launched once
a tick in both runs.  ``chip_smoke.py`` phase 7 does the same at 24 layers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import key_paths
from repro_torch.configs import get_config
from repro_torch.kernels.adaptive_update import cuda as AU
from repro_torch.optim import transform as T
from repro_torch.run import CheckpointHook, Hook, RunSpec, run
from repro_torch.training import default_adapt_setup

W, K, LR = 8, 8, 0.01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def on_tick(self, ctx):
        self.losses.append(ctx.metrics["loss"].item())


def _spec(path):
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), num_layers=2)
    sched, _, adapt = default_adapt_setup(LR, W, K, device="cpu")
    link = T.scale_by_staleness(sched, LR, m=W, tau_max=adapt.tau_max)
    if path == "sync_fuse":
        pipe, mode, fuse, adapt, refresh = T.chain(T.scale(-LR), T.trace(0.9)), "sync", True, None, 0
    elif path == "async_fuse":
        pipe, mode, fuse, refresh = T.chain(link, T.scale(-LR), T.trace(0.9)), "async", True, 2
    else:
        pipe, mode, fuse, refresh = T.chain(link, T.fused_apply(LR, 0.9)), "async", False, 2
    return RunSpec(cfg=cfg, pipeline=pipe, mode=mode, num_steps=6, batch_size=2, seq_len=128,
                   num_workers=W, ring=K if mode == "async" else 0, ring_dtype="bfloat16",
                   adapt=adapt, fuse=fuse, refresh_every=refresh, seed=0, device="cuda")


def _bits(leaf):
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    return leaf.reshape(-1).view(torch.uint8).cpu()


PATHS = {"async_fuse": "fused_tick", "sync_fuse": "fused_chain",
         "async_fused_apply": "fused_update"}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_resume_on_card_is_bit_identical(cuda_device, tmp_path, path):
    kernel = PATHS[path]
    spec_a, track_a = _spec(path), _Losses()
    AU.reset_launches()
    res_a = run(spec_a, hooks=[track_a, CheckpointHook(str(tmp_path), every=3)])
    torch.cuda.synchronize()
    assert AU.LAUNCHES[kernel] == 6
    final_a = {k: _bits(v) for k, v in key_paths(res_a.state)}
    del res_a

    spec_b, track_b = _spec(path), _Losses()
    AU.reset_launches()
    res_b = run(spec_b, hooks=[track_b], resume_from=str(tmp_path), resume_step=3)
    torch.cuda.synchronize()
    assert AU.LAUNCHES[kernel] == 3
    assert track_b.losses == track_a.losses[3:]
    final_b = {k: _bits(v) for k, v in key_paths(res_b.state)}
    assert list(final_a) == list(final_b)
    assert [k for k in final_a if not torch.equal(final_a[k], final_b[k])] == []
    if spec_a.mode == "async":
        assert final_b[".rng"].numel() == 16  # a CUDA generator: seed and Philox offset
        est_a = T.staleness_link(spec_a.pipeline).estimator
        est_b = T.staleness_link(spec_b.pipeline).estimator
        assert est_a.n_seen == est_b.n_seen > 0
        np.testing.assert_array_equal(est_a.counts, est_b.counts)
