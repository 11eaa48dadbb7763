"""Port parity, attention: the flash kernel's plain version, the banded
sliding-window path, decode against a KV cache and the cache helpers, each
against the reference on the same numpy inputs.

Tolerances: the flash plain version is held to the reference's own kernel
tolerance, 3e-5 for f32 (``tests/test_kernels.py:97,117``).  The blockwise
and decode paths are f32 on both sides and agree to round-off (1e-5); cache
positions and cache writes are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import LAUNCHES, attention_ref, flash_attention
from repro_torch.models import attention as TA

F32_TOL = dict(rtol=3e-5, atol=3e-5)
ROUND_OFF = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(B, S, T, Nq, Nkv, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Nq, H)).astype(np.float32),
            rng.standard_normal((B, T, Nkv, H)).astype(np.float32),
            rng.standard_normal((B, T, Nkv, H)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# B, S, T, Nq, Nkv, H, causal, window, softcap: causal or not, window,
# softcap, GQA and MQA, lengths that are not multiples of the reference's
# 32-wide blocks, and S != T
FLASH_CASES = [
    (2, 64, 64, 4, 2, 16, True, None, None),
    (1, 77, 77, 4, 1, 32, True, 24, None),
    (1, 50, 90, 4, 4, 16, False, None, 50.0),
    (2, 45, 45, 8, 2, 16, False, 10, 30.0),
    (1, 128, 128, 4, 2, 16, True, 24, 50.0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_flash_matches_reference_kernel_and_oracle(case):
    B, S, T, Nq, Nkv, H, causal, window, softcap = case
    q, k, v = _qkv(B, S, T, Nq, Nkv, H, seed=S + T)
    before = dict(LAUNCHES)
    got = flash_attention(*_t(q, k, v), causal=causal, window=window, softcap=softcap).numpy()
    assert LAUNCHES == before, "the CPU path launched (counted) a kernel"
    kw = dict(causal=causal, window=window, softcap=softcap)
    want_kernel = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
                                    block_k=32, interpret=True, **kw)
    want_ref = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(want_ref), **F32_TOL)


def test_plain_flash_scale_and_bf16_follow_the_reference():
    """An explicit scale, and bf16 in -> bf16 out (f32 math inside)."""
    q, k, v = _qkv(1, 40, 40, 4, 2, 16, seed=3)
    got = attention_ref(*_t(q, k, v), scale=0.5, window=16).numpy()
    want = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.5, window=16)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = flash_attention(qb, kb, vb)
    assert out.dtype == torch.bfloat16
    want = j_attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    # both sides compute in f32 and round to bf16 once: at most one bf16 ulp apart
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.parametrize("causal,softcap", [(True, None), (True, 50.0), (False, None)])
def test_banded_blockwise_attention_matches_reference(causal, softcap):
    """window 40 with 32-wide blocks and T = 150 > window + block: the banded path."""
    B, S, Nq, Nkv, H, window = 2, 150, 4, 2, 16, 40
    q, k, v = _qkv(B, S, S, Nq, Nkv, H, seed=11)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    kw = dict(causal=causal, window=window, softcap=softcap, block_q=32, block_k=32)
    got = TA.blockwise_attention(*_t(q, k, v), torch.from_numpy(pos.copy()),
                                 torch.from_numpy(pos.copy()), **kw).numpy()
    want = JA.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), jnp.asarray(pos), **kw)
    np.testing.assert_allclose(got, np.asarray(want), **ROUND_OFF)
    if causal:  # the band holds every key a causal window can see
        full = attention_ref(*_t(q, k, v), causal=True, window=window, softcap=softcap,
                             scale=1.0)
        np.testing.assert_allclose(got, full.numpy(), **ROUND_OFF)


@pytest.mark.parametrize("capacity", [1, 8, 16])
def test_cache_positions_match_reference(capacity):
    for length in range(0, 3 * capacity + 2):
        ln = torch.tensor(length)
        for fn in ("cache_positions_full", "cache_positions_ring"):
            got = getattr(TA, fn)(capacity, ln, 2).numpy()
            want = np.asarray(getattr(JA, fn)(capacity, jnp.int32(length), 2))
            np.testing.assert_array_equal(got, want, err_msg=f"{fn} length {length}")


@pytest.mark.parametrize("ring,capacity", [(True, 8), (True, 32), (False, 24)])
def test_fill_and_update_cache_match_reference(ring, capacity):
    B, S, Nkv, H = 2, 13, 2, 16
    _, k, v = _qkv(B, 1, S, 2, Nkv, H, seed=5)
    got = TA.fill_cache_from_prefill(*_t(k, v), capacity, ring)
    want = JA.fill_cache_from_prefill(jnp.asarray(k), jnp.asarray(v), capacity, ring)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    _, kn, vn = _qkv(B, 1, 1, 2, Nkv, H, seed=6)
    update_t = TA.update_cache_ring if ring else TA.update_cache_full
    update_j = JA.update_cache_ring if ring else JA.update_cache_full
    got = update_t(got, *_t(kn, vn), torch.tensor(S))
    want = update_j(want, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(S))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_matches_reference_and_last_row_of_full(window):
    """One token against the cache of the S tokens before it and itself."""
    B, S, Nq, Nkv, H = 2, 21, 4, 2, 16
    q, k, v = _qkv(B, S, S, Nq, Nkv, H, seed=9)
    cap = window if window else S + 3
    cache = TA.fill_cache_from_prefill(*_t(k, v), cap, ring=window is not None)
    pos_fn = TA.cache_positions_ring if window else TA.cache_positions_full
    cpos = pos_fn(cap, torch.tensor(S), B)
    qpos = torch.full((B, 1), S - 1)
    got = TA.decode_attention(torch.from_numpy(q[:, -1:]), cache["k"], cache["v"], cpos, qpos,
                              window=window, softcap=30.0).numpy()
    want = JA.decode_attention(jnp.asarray(q[:, -1:]), jnp.asarray(cache["k"].numpy()),
                               jnp.asarray(cache["v"].numpy()), jnp.asarray(cpos.numpy()),
                               jnp.asarray(qpos.numpy()), window=window, softcap=30.0)
    np.testing.assert_allclose(got, np.asarray(want), **ROUND_OFF)
    full = attention_ref(*_t(q, k, v), causal=True, window=window, softcap=30.0, scale=1.0)
    np.testing.assert_allclose(got, full[:, -1:].numpy(), **ROUND_OFF)
