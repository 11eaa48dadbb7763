"""Port parity, Mamba-1: the selective scan's plain version against the
reference's Pallas kernel (interpret mode) and its oracles, and the Mamba
block's full-sequence, prefill-cache and decode-step paths against the
reference on the same params (reduced falcon-mamba-7b: d_model 256,
d_inner 512, dt_rank 16, N 16), with f32 and with bf16 activations.

Tolerances: the plain scan is held to the reference's own kernel tolerance,
3e-5 (``tests/test_kernels.py:137-138``).  The block paths in f32 agree to
round-off, 1e-5.  In bf16 the two frameworks round intermediates at
different places (XLA on the CPU may compute a fused elementwise chain in
f32 where PyTorch rounds after each op), so the bf16 values differ by about
an ulp (2^-8 relative).  bf16 results, and the f32 state h they feed, are
held to 4 ulps in norm (||got - want|| <= 1.6e-2 ||want||) and to 5 ulps of
the largest value element by element (|got - want| <= 2e-2 max|want|); the
worst cases seen are 0.73 % in norm and 0.89 % of the largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.kernels.selective_scan.ops import selective_scan as j_selective_scan
from repro.kernels.selective_scan.ref import selective_scan_ref as j_kernel_ref
from repro.models import ssm as JS
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.selective_scan import LAUNCHES, selective_scan
from repro_torch.models import ssm as TS

F32_TOL = dict(rtol=3e-5, atol=3e-5)
ROUND_OFF = dict(rtol=1e-5, atol=1e-5)
BF16 = "bf16"  # the norm and elementwise bounds of the module docstring
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _scan_inputs(B, S, D, N, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, D)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, S, D)) - 2.0)).astype(np.float32)  # softplus
    A = -np.exp(0.5 * rng.standard_normal((D, N)) + 1.0).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return u, delta, A, Bm, Cm


@pytest.mark.parametrize("B,S,D,N,udt", [
    (2, 37, 8, 4, "float32"),
    (1, 96, 16, 8, "bfloat16"),
    (2, 50, 48, 16, "float32"),
    (1, 96, 48, 16, "bfloat16"),
    (3, 17, 16, 16, "bfloat16"),
])
def test_plain_scan_matches_reference_kernel_and_oracles(B, S, D, N, udt):
    u, delta, A, Bm, Cm = _scan_inputs(B, S, D, N, seed=S * 7 + D + N)
    jdt, tdt = DTYPES[udt]
    ju = jnp.asarray(u).astype(jdt)
    j_rest = [jnp.asarray(a) for a in (delta, A, Bm, Cm)]
    t_rest = [torch.from_numpy(a) for a in (delta, A, Bm, Cm)]
    y, hT = selective_scan(torch.from_numpy(u).to(tdt), *t_rest)
    assert LAUNCHES["selective_scan"] == 0, "the CPU path launched (counted) a kernel"
    assert y.dtype == hT.dtype == torch.float32 and hT.shape == (B, D, N)
    want_kernel = j_selective_scan(ju, *j_rest, block_d=8, chunk=16, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_kernel), **F32_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_kernel_ref(ju, *j_rest)), **F32_TOL)
    # the final state, against the block-level oracle's (no d_skip)
    _, want_h = JS.selective_scan_ref(ju, *j_rest, jnp.zeros((D,), jnp.float32))
    np.testing.assert_allclose(hT.numpy(), np.asarray(want_h), **F32_TOL)


@pytest.fixture(scope="module")
def block():
    jcfg = j_reduced(j_get_config("falcon-mamba-7b"))
    tcfg = reduced(get_config("falcon-mamba-7b"))
    assert (tcfg.d_model, tcfg.d_inner, tcfg.dt_rank, tcfg.ssm_state) == (256, 512, 16, 16)
    jp = JS.init_ssm(jax.random.PRNGKey(3), jcfg)
    tp = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), jp)
    x = (0.5 * np.random.default_rng(0).standard_normal((2, 40, jcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _close(got: torch.Tensor, want, tol):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if tol != BF16:
        np.testing.assert_allclose(got, want, **tol)
        return
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= 1.6e-2 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_init_draws_and_deterministic_leaves_are_the_reference_ones(block):
    jcfg, tcfg, jp, _, _ = block
    tp = TS.init_ssm(torch.Generator().manual_seed(0), tcfg, "cpu")
    for name in ("dt_bias", "a_log", "d_skip", "conv_b"):
        assert tp[name].dtype == torch.float32
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]), err_msg=name)
    for name in ("dt", "b", "c"):
        np.testing.assert_array_equal(tp["bc_norm"][name].numpy(), np.asarray(jp["bc_norm"][name]))
    assert {k: tuple(v.shape) for k, v in tp.items() if k != "bc_norm"} == {
        k: tuple(v.shape) for k, v in jp.items() if k != "bc_norm"}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_apply_ssm_matches_reference(block, use_pallas, dtype):
    """With use_pallas the reference runs its Pallas kernel in interpret mode
    and the port its kernel's wrapper (the plain version on the CPU)."""
    jcfg, tcfg, jp, tp, x = block
    jdt, tdt = DTYPES[dtype]
    want = JS.apply_ssm(jp, jnp.asarray(x).astype(jdt),
                        dataclasses.replace(jcfg, use_pallas=use_pallas))
    got = TS.apply_ssm(tp, torch.from_numpy(x).to(tdt),
                       dataclasses.replace(tcfg, use_pallas=use_pallas))
    assert got.dtype == tdt
    _close(got, want, ROUND_OFF if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_cache_matches_reference(block, use_pallas, dtype):
    """Output, conv window and h: the port takes h from the scan that gave
    the output, the reference from a second plain scan."""
    jcfg, tcfg, jp, tp, x = block
    jdt, tdt = DTYPES[dtype]
    want_out, want_cache = JS.ssm_prefill_cache(jp, jnp.asarray(x).astype(jdt), jcfg, jnp.float32)
    got_out, got_cache = TS.ssm_prefill_cache(tp, torch.from_numpy(x).to(tdt),
                                              dataclasses.replace(tcfg, use_pallas=use_pallas),
                                              torch.float32)
    f32 = dtype == "float32"
    _close(got_out, want_out, ROUND_OFF if f32 else BF16)
    assert got_cache["conv"].dtype == got_cache["h"].dtype == torch.float32
    _close(got_cache["conv"], want_cache["conv"], ROUND_OFF if f32 else BF16)
    _close(got_cache["h"], want_cache["h"], ROUND_OFF if f32 else BF16)
    assert got_cache["conv"]._base is None, "the conv tail must be a copy, not a view"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_step_matches_reference(block, dtype):
    """One step from the same f32 cache: the cache promotes the window and
    the projections to f32, the output is cast back to the activation dtype."""
    jcfg, tcfg, jp, tp, x = block
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    conv = rng.standard_normal((2, jcfg.ssm_conv - 1, jcfg.d_inner)).astype(np.float32)
    h = (0.3 * rng.standard_normal((2, jcfg.d_inner, jcfg.ssm_state))).astype(np.float32)
    want_y, want_c = JS.apply_ssm_step(jp, jnp.asarray(x[:, :1]).astype(jdt),
                                       {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}, jcfg)
    cache = {"conv": torch.from_numpy(conv.copy()), "h": torch.from_numpy(h.copy())}
    got_y, got_c = TS.apply_ssm_step(tp, torch.from_numpy(x[:, :1]).to(tdt), cache, tcfg)
    assert got_c is cache, "the decode step updates its cache in place"
    assert got_y.dtype == tdt and got_c["conv"].dtype == torch.float32
    _close(got_y, want_y, ROUND_OFF if dtype == "float32" else BF16)
    for name in ("conv", "h"):
        _close(got_c[name], want_c[name], ROUND_OFF if dtype == "float32" else BF16)
