"""The sharded async engine on the card (``mode="sharded_async"``, fused).

This file imports no JAX, so it runs on a machine with a card and PyTorch
alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_sharded.py

It skips without a card.
* Reduced stablelm-1.6b (2 layers), fused momentum, an f32 ring of 4, 4
  ticks with a refresh every 2, W = 2 and 4 heterogeneous workers: the card
  (one ``fused_chain`` launch a tick, no ``fused_tick``) against the plain
  CPU path on the same params, batches and uniforms, max |dp| <= 1e-5 (the
  tolerance and ring of ``chip_smoke.py``'s reduced async check); the
  histograms and the refreshed alpha table exactly equal.  (With a bf16
  ring a 1e-7 gradient difference can flip a bf16 rounding, 2^-8 of the
  element: the card read 3.7e-5 there, which no f32 bound describes.)
* The in-place ring ops on the card: the async and per-worker pushes keep
  the ring's storage, write only slot ``step % K`` (every other slot's bits
  untouched) and combine as the CPU does (1e-6).
"""

import numpy as np
import pytest
import torch

from repro_torch.async_engine import delayed as D
from repro_torch.configs import get_config, reduced
from repro_torch.core import staleness as S
from repro_torch.core.step_size import make_schedule
from repro_torch.kernels.adaptive_update import cuda as AU
from repro_torch.optim import transform as T
from repro_torch.run import RunSpec, run
from repro_torch.training import init_params, make_worker_adapt


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


def _samplers(W):
    out = [S.Geometric(0.3), np.arange(11) % 4, S.Poisson(2.0), S.CMP.from_mode(W, 0.9)]
    return out[:W]


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 4])
def test_sharded_fused_on_card_matches_cpu(cuda_device, W):
    cfg = reduced(get_config("stablelm-1.6b"))
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    draws = np.random.default_rng(0).random((4, W)).astype(np.float32)
    finals = {}
    for device in ("cpu", "cuda"):
        it = iter(draws)
        sched = make_schedule("poisson_momentum", 0.05, S.Poisson(float(W)), K=0.05, tau_max=16)
        adapt = make_worker_adapt(sched.table, _samplers(W), cdf_support=4)
        pipe = T.chain(T.scale_by_staleness(sched, 0.05, m=W, tau_max=16), T.scale(-0.05),
                       T.trace(0.9))
        AU.reset_launches()
        res = run(RunSpec(cfg=cfg, pipeline=pipe, mode="sharded_async", num_steps=4,
                          batch_size=2, seq_len=64, ring=4, adapt=adapt,
                          fuse=True, params=flat, refresh_every=2, seed=0, device=device,
                          tau_source=lambda: torch.from_numpy(next(it))))
        if device == "cuda":
            torch.cuda.synchronize()
            assert AU.LAUNCHES["fused_chain"] == 4 and AU.LAUNCHES["fused_tick"] == 0
        s = res.state
        finals[device] = (s.params.cpu(), s.adapt.hist.cpu(), s.adapt.alpha_table.cpu(),
                          s.delayed.ring.cpu())
    (pc, hc, tc, rc), (pg, hg, tg, rg) = finals["cpu"], finals["cuda"]
    assert (pg - pc).abs().max().item() <= 1e-5
    assert torch.equal(hg, hc) and torch.equal(tg, tc)
    assert rg.shape == rc.shape == (W, 4, flat.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_push_and_gather_on_card(cuda_device, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    Wl, K, n, step = 3, 4, (1 << 20) + 3, 9
    ring = torch.randn((Wl, K, n), generator=gen, device="cuda").to(dtype)
    g = torch.randn(n, generator=gen, device="cuda")
    taus = torch.tensor([0, 2, 7], dtype=torch.int32, device="cuda")
    weights = torch.rand(Wl, generator=gen, device="cuda")
    st = torch.tensor(step, dtype=torch.int32, device="cuda")
    keep = [k for k in range(K) if k != step % K]
    before = ring[:, keep].clone()
    cpu_g, cpu_live, cpu_ring = D.worker_ring_combine(ring.cpu(), st.cpu(), g.cpu(), taus.cpu(),
                                                      weights.cpu())
    ptr = ring.data_ptr()
    got, live, new = D.worker_ring_combine(ring, st, g, taus, weights)
    assert new is ring and ring.data_ptr() == ptr
    assert torch.equal(ring[:, keep].view(torch.uint8), before.view(torch.uint8))
    assert torch.equal(ring[:, step % K], g.to(dtype).expand(Wl, n))
    assert torch.equal(ring.cpu().view(torch.uint8), cpu_ring.view(torch.uint8))
    assert torch.equal(live.cpu(), cpu_live)
    assert (got.cpu() - cpu_g).abs().max().item() <= 1e-6 * (1 + cpu_g.abs().max().item())

    flat = ring[0].clone()
    before = flat[keep].clone()
    ptr = flat.data_ptr()
    out, _, state = D.delayed_combine(D.DelayedGradients(ring=flat, step=st), g, taus, weights)
    assert state.ring is flat and flat.data_ptr() == ptr and int(state.step) == step + 1
    assert torch.equal(flat[keep].view(torch.uint8), before.view(torch.uint8))
    assert torch.isfinite(out).all()
