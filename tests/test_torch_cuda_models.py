"""The other model families on the card: reduced qwen2-moe-a2.7b,
internvl2-2b, whisper-large-v3 and gemma2-27b served through
``launch.serve.serve`` on the card (``use_pallas=True``: the flash kernel)
against the plain CPU path, same params and prompts.

This file imports no JAX, so it runs on a machine with a card and PyTorch
alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_models.py

It skips without a card.  Tolerances: logits of the prefill and of 4 greedy
steps within 1e-4 (``chip_smoke.py`` phase 6's bound), ids equal; for the
MoE the first MoE layer's top-k expert ids over the prefill exactly equal.
Each card run must have launched the flash kernel (whisper: once per encoder
layer, as its decoder is not prefilled).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch_for
from repro_torch.kernels.flash_attention import cuda as FA
from repro_torch.launch.serve import serve
from repro_torch.models import moe as MOE
from repro_torch.training import init_params
from repro_torch.tree import tree_map

PROMPT, GEN = 160, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


def _serve_keeping_first_route(cfg, params, batch, device, monkeypatch):
    kept = []
    inner = MOE.route

    def keep_first(*args):
        out = inner(*args)
        if not kept:
            kept.append(tuple(t.cpu() for t in out))
        return out

    monkeypatch.setattr(MOE, "route", keep_first)
    result = serve(cfg, tree_map(lambda t: t.to(device), params),
                   {k: v.to(device) for k, v in batch.items()}, gen=GEN)
    monkeypatch.setattr(MOE, "route", inner)
    return result, (kept[0] if kept else None)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internvl2-2b", "whisper-large-v3",
                                  "gemma2-27b"])
def test_reduced_serve_on_the_card_matches_cpu(cuda_device, arch, monkeypatch):
    cfg = reduced(get_config(arch))
    params = init_params(0, cfg, "cpu")
    batch = make_batch_for(cfg, batch=2, seq=PROMPT, seed=0)
    want, want_route = _serve_keeping_first_route(cfg, params, batch, "cpu", monkeypatch)
    FA.reset_launches()
    got, got_route = _serve_keeping_first_route(dataclasses.replace(cfg, use_pallas=True), params,
                                                batch, cuda_device, monkeypatch)
    expected = cfg.num_encoder_layers if cfg.is_encoder_decoder else cfg.num_layers
    assert FA.LAUNCHES["flash_attention"] == expected
    if cfg.is_encoder_decoder:
        assert want["prefill_logits"] is None and got["prefill_logits"] is None
    else:
        torch.testing.assert_close(got["prefill_logits"].cpu(), want["prefill_logits"],
                                   rtol=0, atol=1e-4)
    torch.testing.assert_close(got["logits"].cpu(), want["logits"], rtol=0, atol=1e-4)
    assert torch.equal(got["tokens"].cpu(), want["tokens"])
    if cfg.num_experts:
        assert torch.equal(got_route[2], want_route[2])
