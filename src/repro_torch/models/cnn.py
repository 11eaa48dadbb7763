"""The paper's experimental model: a 4-layer CNN for CIFAR-10 (Fig. 1); port
of ``src/repro/models/cnn.py``.

Four 3x3 convolutions (32, 32, 64, 64 filters) with a 2x2 max-pool after
each pair, then a 256-unit fully-connected layer and a 10-way output, under
a mean cross-entropy: the Fig. 1 architecture of the Fig. 3 convergence
experiments.  Plus the small MLP classifier the CI-scale convergence runs
use.

Layouts are the reference's, so its params carry over as they are
(:func:`repro_torch.bridge.cnn_params_from_jax`): images are NHWC,
convolution weights HWIO, and the features are flattened in NHWC order
before ``fc1`` (flattening NCHW would be another model, with ``fc1``'s rows
permuted).  The convolutions run as ``F.conv2d`` on NCHW views with padding
1, the reference's ``SAME`` for a 3x3 window; TF32 stays off
(:mod:`repro_torch`), so they are full f32 products on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import truncated_normal

__all__ = ["init_cnn", "cnn_forward", "cnn_loss", "init_mlp_classifier", "mlp_forward", "mlp_loss"]

f32 = torch.float32


def _conv_init(gen, kh, kw, cin, cout, device):
    fan_in = kh * kw * cin
    return {
        "w": truncated_normal(gen, (kh, kw, cin, cout), math.sqrt(2.0 / fan_in), device),
        "b": torch.zeros((cout,), dtype=f32, device=device),
    }


def init_cnn(gen: torch.Generator | None, *, in_channels: int = 3, num_classes: int = 10,
             image: int = 32, device="cuda") -> dict:
    """Random Fig.-1 CNN params from ``gen`` (torch's draws, not jax's)."""
    flat = (image // 4) * (image // 4) * 64  # two 2x2 max-pools
    return {
        "conv1": _conv_init(gen, 3, 3, in_channels, 32, device),
        "conv2": _conv_init(gen, 3, 3, 32, 32, device),
        "conv3": _conv_init(gen, 3, 3, 32, 64, device),
        "conv4": _conv_init(gen, 3, 3, 64, 64, device),
        "fc1": {
            "w": truncated_normal(gen, (flat, 256), math.sqrt(2.0 / flat), device),
            "b": torch.zeros((256,), dtype=f32, device=device),
        },
        "out": {
            "w": truncated_normal(gen, (256, num_classes), math.sqrt(1.0 / 256), device),
            "b": torch.zeros((num_classes,), dtype=f32, device=device),
        },
    }


def _conv(p, x):
    """3x3 'SAME' convolution of NCHW ``x`` with an HWIO weight."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=1) + p["b"][None, :, None, None]


def cnn_forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_conv(params["conv1"], x))
    x = F.max_pool2d(F.relu(_conv(params["conv2"], x)), 2)
    x = F.relu(_conv(params["conv3"], x))
    x = F.max_pool2d(F.relu(_conv(params["conv4"], x)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as the reference
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def cnn_loss(params: dict, batch: dict) -> torch.Tensor:
    """Mean cross-entropy — the paper's performance metric (§VI)."""
    return _xent(cnn_forward(params, batch["images"]), batch["labels"])


# ---------------------------------------------------------------------------
# Small MLP classifier — the cheaper stand-in of the CI-scale convergence runs
# ---------------------------------------------------------------------------

def init_mlp_classifier(gen: torch.Generator | None, *, d_in: int, d_hidden: int = 128,
                        num_classes: int = 10, device="cuda") -> dict:
    return {
        "fc1": {
            "w": truncated_normal(gen, (d_in, d_hidden), math.sqrt(2.0 / d_in), device),
            "b": torch.zeros((d_hidden,), dtype=f32, device=device),
        },
        "out": {
            "w": truncated_normal(gen, (d_hidden, num_classes), math.sqrt(1.0 / d_hidden), device),
            "b": torch.zeros((num_classes,), dtype=f32, device=device),
        },
    }


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


def mlp_loss(params: dict, batch: dict) -> torch.Tensor:
    return _xent(mlp_forward(params, batch["x"]), batch["labels"])
