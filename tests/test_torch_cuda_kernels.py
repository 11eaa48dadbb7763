"""The port's flash-attention, RG-LRU and selective-scan kernels against
their plain versions, on the card; the CPU path of each wrapper here.

This file imports no JAX, so its ``cuda``-marked tests run on a machine with
a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

They skip without a card.  Tolerances: 3e-5 in f32, the reference's own
kernel tolerance (``tests/test_kernels.py:97,117,165``); in bf16 1e-4 +
1e-2 |plain|, one bf16 rounding of the output, since kernel and plain version
both compute in f32 and round once (the reference's 3e-2 is as large as a
typical output at long windows); the selective scan's y and final state at
the reference's 3e-5 (``tests/test_kernels.py:137-138``); the served logits
1e-4.  Full-width shapes are ``chip_smoke.py``'s.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rg_lru as RG
from repro_torch.kernels import selective_scan as SS
from repro_torch.launch.serve import serve
from repro_torch.training import init_params
from repro_torch.tree import tree_map


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


def _qkv(B, S, T, Nq, Nkv, H, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(device=device, dtype=dtype)
                 for shape in ((B, S, Nq, H), (B, T, Nkv, H), (B, T, Nkv, H)))


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    q, k, v = _qkv(1, 20, 20, 4, 2, 64, torch.float32, "cpu")
    before = dict(FA.LAUNCHES), dict(RG.LAUNCHES), dict(SS.LAUNCHES)
    assert torch.equal(FA.flash_attention(q, k, v, window=8, softcap=20.0),
                       FA.attention_ref(q, k, v, window=8, softcap=20.0))
    log_a, x = -torch.rand(2, 9, 16), torch.randn(2, 9, 16)
    assert torch.equal(RG.rg_lru(log_a, x), RG.rg_lru_ref(log_a, x))
    for u_dtype in (torch.float32, torch.bfloat16):
        scan_in = _scan_inputs(2, 9, 12, 4, u_dtype, "cpu")
        for got, want in zip(SS.selective_scan(*scan_in), SS.selective_scan_ref(*scan_in)):
            assert torch.equal(got, want)
    assert (dict(FA.LAUNCHES), dict(RG.LAUNCHES), dict(SS.LAUNCHES)) == before


# B, S, T, Nq, Nkv, H, causal, window, softcap, dtype
FLASH_CASES = [
    (2, 100, 100, 4, 2, 64, True, None, None, torch.float32),
    (1, 77, 150, 4, 4, 256, False, 40, None, torch.float32),
    (1, 130, 130, 32, 16, 128, True, 64, 50.0, torch.float32),
    (2, 300, 300, 16, 1, 256, True, 100, None, torch.bfloat16),
    (1, 2200, 2200, 16, 1, 256, True, 2048, None, torch.float32),
    (1, 2200, 2200, 16, 1, 256, True, 2048, None, torch.bfloat16),
    # the tensor-core body's edges, one head width each
    (3, 333, 333, 8, 8, 64, True, None, None, torch.bfloat16),  # ragged S, 3 q tiles
    (1, 300, 300, 8, 4, 128, True, 50, 30.0, torch.bfloat16),  # GQA 2, window < tile, softcap
    (1, 77, 150, 4, 4, 256, False, 40, None, torch.bfloat16),  # S != T, non-causal window
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c[:9])))
def test_flash_kernel_matches_plain_on_card(cuda_device, case):
    *shape, causal, window, softcap, dtype = case
    q, k, v = _qkv(*shape, dtype, cuda_device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = FA.LAUNCHES["flash_attention"]
    out = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == n0 + 1
    rtol, atol = (3e-5, 3e-5) if dtype == torch.float32 else (1e-2, 1e-4)
    torch.testing.assert_close(out.float(), FA.attention_ref(q, k, v, **kw).float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(1, 8, 8, 2, 1, 32, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, k, v)
    q, k, v = _qkv(1, 8, 8, 2, 1, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="forward-only"):
        FA.flash_attention(q.requires_grad_(), k, v)
    # the bf16 body loads by TMA: a row stride of 65 elements is not 16-byte aligned
    q, k, v = _qkv(1, 8, 8, 2, 1, 65, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(q[..., :64], k[..., :64], v[..., :64])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(2, 37, 100), (3, 100, 4096)])
def test_rg_lru_kernel_matches_plain_on_card(cuda_device, B, S, W):
    g = torch.Generator().manual_seed(S)
    log_a = -torch.nn.functional.softplus(torch.randn(B, S, W, generator=g)).to(cuda_device)
    x = torch.randn(B, S, W, generator=g).to(cuda_device)
    n0 = RG.LAUNCHES["rg_lru"]
    y = RG.rg_lru(log_a, x)
    torch.cuda.synchronize()
    assert RG.LAUNCHES["rg_lru"] == n0 + 1
    torch.testing.assert_close(y, RG.rg_lru_ref(log_a, x), rtol=3e-5, atol=3e-5)


def _scan_inputs(B, S, D, N, u_dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(B, S, D, generator=g).to(u_dtype)
    delta = torch.nn.functional.softplus(torch.randn(B, S, D, generator=g) - 2.0)
    A = -torch.exp(0.5 * torch.randn(D, N, generator=g) + 1.0)
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g)
    return tuple(t.to(device) for t in (u, delta, A, Bm, Cm))


# B, S, D, N, u dtype: odd S and D, D not a multiple of 32, N below 16, a
# time chunk's ragged end
SCAN_CASES = [
    (2, 37, 100, 16, torch.float32),
    (2, 37, 100, 16, torch.bfloat16),
    (3, 50, 48, 8, torch.bfloat16),
    (1, 33, 65, 16, torch.float32),
    (2, 5, 3, 3, torch.float32),
    (2, 1000, 1000, 16, torch.float32),
    (2, 200, 513, 16, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_selective_scan_kernel_matches_plain_on_card(cuda_device, case):
    *shape, u_dtype = case
    scan_in = _scan_inputs(*shape, u_dtype, cuda_device, seed=shape[1])
    n0 = SS.LAUNCHES["selective_scan"]
    y, hT = SS.selective_scan(*scan_in)
    torch.cuda.synchronize()
    assert SS.LAUNCHES["selective_scan"] == n0 + 1
    want_y, want_h = SS.selective_scan_ref(*scan_in)
    torch.testing.assert_close(y, want_y, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(hT, want_h, rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
def test_selective_scan_refuses_what_it_does_not_take(cuda_device):
    u, delta, A, Bm, Cm = _scan_inputs(1, 8, 16, 4, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="N <= 16"):
        SS.selective_scan(u, delta, torch.zeros(16, 17, device=cuda_device), Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        SS.selective_scan(u.transpose(1, 2).contiguous().transpose(1, 2), delta, A, Bm, Cm)
    with pytest.raises(ValueError, match="dtype"):
        SS.selective_scan(u.half(), delta, A, Bm, Cm)


@pytest.mark.cuda
def test_served_recurrentgemma_on_card_matches_cpu(cuda_device):
    """Reduced recurrentgemma, prefill + 4 greedy steps: the card with
    use_pallas (the kernels) against the CPU's plain path, same params."""
    cfg = reduced(get_config("recurrentgemma-9b"))
    params = init_params(0, cfg, "cpu")
    batch = make_batch_for(cfg, batch=2, seq=96, seed=0)
    want = serve(cfg, params, batch, gen=4)
    got = serve(dataclasses.replace(cfg, use_pallas=True),
                tree_map(lambda t: t.to(cuda_device), params),
                {k: v.to(cuda_device) for k, v in batch.items()}, gen=4)
    torch.testing.assert_close(got["prefill_logits"].cpu(), want["prefill_logits"], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(got["logits"].cpu(), want["logits"], rtol=0, atol=1e-4)
    assert torch.equal(got["tokens"].cpu(), want["tokens"])


@pytest.mark.cuda
def test_served_falcon_mamba_on_card_matches_cpu(cuda_device):
    """Reduced falcon-mamba, prefill + 4 greedy steps: the card with
    use_pallas (the selective-scan kernel) against the CPU's plain path."""
    cfg = reduced(get_config("falcon-mamba-7b"))
    params = init_params(0, cfg, "cpu")
    batch = make_batch_for(cfg, batch=2, seq=96, seed=0)
    want = serve(cfg, params, batch, gen=4)
    n0 = SS.LAUNCHES["selective_scan"]
    got = serve(dataclasses.replace(cfg, use_pallas=True),
                tree_map(lambda t: t.to(cuda_device), params),
                {k: v.to(cuda_device) for k, v in batch.items()}, gen=4)
    assert SS.LAUNCHES["selective_scan"] == n0 + cfg.num_layers
    torch.testing.assert_close(got["prefill_logits"].cpu(), want["prefill_logits"], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(got["logits"].cpu(), want["logits"], rtol=0, atol=1e-4)
    assert torch.equal(got["tokens"].cpu(), want["tokens"])
