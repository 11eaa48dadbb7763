"""The port's flash-attention, RG-LRU and selective-scan kernels, and the
tick kernel's dead ring slots, against their plain versions, on the card;
the CPU path of each wrapper here.

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
from repro_torch.kernels.adaptive_update import cuda as AU
from repro_torch.kernels.adaptive_update import ref as AU_REF
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


def _scan_inputs(B, S, D, N, u_dtype, device, seed=0, a_init="wide"):
    """``a_init``: "wide" is -exp(0.5 randn + 1); "randn" is -exp(randn) per
    (d, n), as ``chip_smoke.py``'s random-A shape."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(B, S, D, generator=g).to(u_dtype)
    delta = torch.nn.functional.softplus(torch.randn(B, S, D, generator=g) - 2.0)
    if a_init == "wide":
        A = -torch.exp(0.5 * torch.randn(D, N, generator=g) + 1.0)
    else:
        A = -torch.exp(torch.randn(D, N, generator=g))
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g)
    return tuple(t.to(device) for t in (u, delta, A, Bm, Cm))


# B, S, D, N, u dtype, A.  The kernel cuts time into chunks of 32 steps,
# 16 a thread in 2 segments, and takes 64 channels a block; D % 8 == 0
# stages delta and u by cp.async, other D load them directly.  Odd S and D,
# D not a multiple of 32, N below 16, a time chunk's ragged end.
SCAN_CASES = [
    (2, 37, 100, 16, torch.float32, "wide"),
    (2, 37, 100, 16, torch.bfloat16, "wide"),
    (3, 50, 48, 8, torch.bfloat16, "wide"),
    (1, 33, 65, 16, torch.float32, "wide"),
    (2, 5, 3, 3, torch.float32, "wide"),
    (2, 1000, 1000, 16, torch.float32, "wide"),
    (2, 200, 513, 16, torch.bfloat16, "wide"),
    # several chunks, the last ragged: 173 = 5 * 32 + 13 leaves its first
    # segment 13 of 16 steps and its second segment empty
    (2, 173, 128, 16, torch.float32, "randn"),
    (2, 173, 128, 16, torch.bfloat16, "randn"),
    # S shorter than a thread's 16 steps, and S = 1
    (2, 5, 64, 16, torch.bfloat16, "randn"),
    (3, 1, 80, 16, torch.float32, "randn"),
    # D a multiple of 8 but not of the block's 64 channels (staged, ragged block)
    (2, 77, 72, 16, torch.bfloat16, "randn"),
    (1, 70, 200, 5, torch.float32, "randn"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_selective_scan_kernel_matches_plain_on_card(cuda_device, case):
    *shape, u_dtype, a_init = case
    scan_in = _scan_inputs(*shape, u_dtype, cuda_device, seed=shape[1], a_init=a_init)
    n0 = SS.LAUNCHES["selective_scan"]
    y, hT = SS.selective_scan(*scan_in)
    torch.cuda.synchronize()
    assert SS.LAUNCHES["selective_scan"] == n0 + 1
    want_y, want_h = SS.selective_scan_ref(*scan_in)
    torch.testing.assert_close(y, want_y, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(hT, want_h, rtol=3e-5, atol=3e-5)


DELTA_RANGES = {
    # decays near 1 over thousands of steps: an error in each decay builds up in the carry
    "tiny": lambda g, shape: 1e-4 * torch.rand(shape, generator=g),
    # decays that underflow to 0
    "large": lambda g, shape: 20.0 + 10.0 * torch.rand(shape, generator=g),
    # log-uniform from 1e-4 to 30
    "mixed": lambda g, shape: torch.exp(torch.empty(shape).uniform_(-9.2, 3.4, generator=g)),
}


def _scan_terms(u, delta, A, Bm, Cm):
    """sum_n |h_t[d, n] C_t[n]| per (b, t, d): the size of the terms y sums."""
    u, delta = u.float(), delta.float()
    h = torch.zeros((u.shape[0], u.shape[2], A.shape[1]), device=u.device)
    out = torch.empty_like(delta)
    for t in range(u.shape[1]):
        dt = delta[:, t, :, None]
        h = torch.exp(dt * A) * h + dt * Bm[:, t, None, :] * u[:, t, :, None]
        out[:, t] = (h * Cm[:, t, None, :]).abs().sum(-1)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("delta_range", list(DELTA_RANGES))
def test_selective_scan_kernel_holds_over_delta_ranges(cuda_device, delta_range, u_dtype):
    """A = -exp(randn) per (d, n) and delta from 1e-4 to 30, over 3000
    steps, against the f32 plain version and against the plain scan in f64,
    a witness of the f32 rounding.  hT is held to the reference's 3e-5 +
    3e-5 |plain| against both.  y sums 16 terms h C, which with delta near 30
    are ~40 each where y is ~0.1: there the f32 plain version itself misses
    3e-5 + 3e-5 |y| against the f64 scan, as far as the kernel does (PERF.md
    gives the readings), so y is held to 3e-5 (1 + sum_n |h C|), the
    reference's 3e-5 relative to the size of what it sums, against both."""
    B, S, D, N = 1, 3000, 64, 16
    u, _, A, Bm, Cm = _scan_inputs(B, S, D, N, u_dtype, "cpu", seed=11, a_init="randn")
    delta = DELTA_RANGES[delta_range](torch.Generator().manual_seed(12), (B, S, D))
    scan_in = tuple(t.to(cuda_device) for t in (u, delta, A, Bm, Cm))
    y, hT = SS.selective_scan(*scan_in)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hT).all())
    terms = _scan_terms(*scan_in).double()
    for dtype in (torch.float32, torch.float64):
        want_y, want_h = SS.selective_scan_ref(*scan_in, dtype=dtype)
        torch.testing.assert_close(hT.double(), want_h.double(), rtol=3e-5, atol=3e-5)
        excess = (y.double() - want_y).abs() - 3e-5 * (1 + terms)
        assert float(excess.max()) <= 0, \
            f"y past 3e-5 (1 + sum |h C|) of the {dtype} scan by {float(excess.max())}"


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


@pytest.mark.cuda
@pytest.mark.parametrize("ring_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam"])
def test_tick_kernel_never_reads_dead_slots(cuda_device, kind, ring_dtype):
    """At step 11 with taus (0, 2, 5, 2, 9, 1, 3, 7) and K = 8 no worker maps
    to ring slots 5 and 7 (tau 9 >= K is dead).  Filled with NaN, they must
    not reach p or the state: the plain version gathers only the workers'
    slots and stays finite, and the kernel must match it (1e-6, 1e-5 with a
    bf16 ring; ring bits and the live mask exactly)."""
    n, K = 100003, 8
    g = torch.Generator().manual_seed(3)
    taus = torch.tensor([0, 2, 5, 2, 9, 1, 3, 7], dtype=torch.int32)
    weights = torch.rand(8, generator=g) + 0.1
    p0, grad = torch.randn(n, generator=g), torch.randn(n, generator=g)
    ring0 = torch.randn(K, n, generator=g)
    ring0[[5, 7]] = float("nan")
    state = {"sgd": (), "momentum": torch.randn(n, generator=g),
             "adam": {"m": torch.randn(n, generator=g), "v": torch.rand(n, generator=g) + 0.1}}[kind]
    s = {k: torch.tensor(v) for k, v in {
        "f_stale": 1.3, "f_keep": 1.0, "f_clip": 0.7, "m_scale": -0.05, "mu": 0.9, "b1": 0.9,
        "omb1": 0.1, "b2": 0.999, "omb2": 0.001, "eps": 1e-8, "c1": 10.0, "c2": 1000.0}.items()
        if k in AU_REF.SCALAR_ORDER[kind]}

    def on_card(x):
        if isinstance(x, dict):
            return {k: v.to(cuda_device) for k, v in x.items()}
        return x.to(cuda_device) if isinstance(x, torch.Tensor) else x

    step = torch.tensor(11, dtype=torch.int32, device=cuda_device)
    ring = ring0.to(ring_dtype).to(cuda_device)
    args = (on_card(taus), on_card(weights))
    p_ref, b_ref, r_ref, l_ref = AU_REF.fused_tick_ref(
        kind, on_card(p0), on_card(grad), on_card(state), s, ring.clone(), step, *args)
    assert bool(torch.isfinite(p_ref).all())
    p, b = on_card(p0), on_card(state)
    n0 = AU.LAUNCHES["fused_tick"]
    live = AU.fused_tick(kind, p, on_card(grad), b, s, ring, step, *args)
    torch.cuda.synchronize()
    assert AU.LAUNCHES["fused_tick"] == n0 + 1
    tol = 1e-6 if ring_dtype == torch.float32 else 1e-5
    pairs = [(p, p_ref)] + ([(b, b_ref)] if kind == "momentum" else
                            [(b[k], b_ref[k]) for k in ("m", "v")] if kind == "adam" else [])
    for got, want in pairs:
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(live, l_ref)
    bits = torch.int16 if ring_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(ring.view(bits), r_ref.view(bits))


@pytest.mark.cuda
def test_bf16_params_fused_async_run_on_card_matches_cpu(cuda_device):
    """param_dtype="bfloat16": the bf16 param tree is packed to f32 for the
    fused tick kernel and cast back each tick.  Reduced stablelm, 4 fused
    async momentum ticks on the card (the kernel) against the CPU (the
    plain versions), same params, batches and uniforms.  The layout is the
    reference's (bf16 tree, bf16 ring); the params agree to within two bf16
    ulps of each leaf's largest value, 0.5 % of them past one ulp of their
    own (the CPU parity test's bounds, tests/test_torch_param_dtype.py)."""
    import numpy as np

    from repro_torch.optim import transform as T
    from repro_torch.run import RunSpec, run
    from repro_torch.training import default_adapt_setup
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), d_model=128),
                              param_dtype="bfloat16")
    flat = T.pack_flat(init_params(0, cfg, "cpu"))
    draws = np.random.default_rng(0).random((4, 4)).astype(np.float32)
    finals = {}
    for device in ("cpu", "cuda"):
        it = iter(draws)
        sched, _, adapt = default_adapt_setup(0.05, 4, 4, device="cpu")
        pipe = T.chain(T.scale_by_staleness(sched, 0.05, m=4, tau_max=adapt.tau_max),
                       T.scale(-0.05), T.trace(0.9))
        state = run(RunSpec(cfg=cfg, pipeline=pipe, mode="async", num_steps=4, batch_size=2,
                            seq_len=32, num_workers=4, ring=4, adapt=adapt, fuse=True,
                            params=flat, refresh_every=2, seed=0, device=device,
                            tau_source=lambda: torch.from_numpy(next(it)))).state
        assert isinstance(state.params, dict) and state.delayed.ring.dtype == torch.bfloat16
        finals[device] = [leaf.float().cpu() for leaf in tree_leaves(state.params)]
    n_far = total = 0
    for got, want in zip(finals["cuda"], finals["cpu"]):
        d = (got - want).abs()
        assert float(d.max()) <= 2 * 2.0 ** -7 * float(want.abs().max())
        n_far += int((d > 1e-6 + 2.0 ** -7 * want.abs()).sum())
        total += want.numel()
    assert n_far <= 5e-3 * total
