"""The FEMNIST CNN of the Multi-FedLS paper (arXiv:2308.08967, section
5.6) in plain PyTorch, float32: two 5x5 SAME convolutions (32 and 64
channels), each with ReLU and a 2x2 max pool, then ``n_fc`` fully
connected ReLU layers of ``fc_width`` and a linear head over the classes;
mean cross-entropy.

Weights come in the system's layout: images NHWC, convolution kernels
HWIO, dense ``w`` (in, out) and ``b``; the pooled features are flattened
in NHWC order.  Departure: random weights from the seed.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .common import Precision


def _conv(p: Dict[str, torch.Tensor], x: torch.Tensor, prec: Precision) -> torch.Tensor:
    w = prec.q(p["w"]).permute(3, 2, 0, 1)
    return F.conv2d(prec.q(x), w, p["b"], padding="same")


def logits(params: Dict[str, Any], images: torch.Tensor, cfg: Dict[str, Any],
           prec: Precision) -> torch.Tensor:
    h = images.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(_conv(params["conv1"], h, prec)), 2)
    h = F.max_pool2d(F.relu(_conv(params["conv2"], h, prec)), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    for i in range(cfg["n_fc"]):
        h = F.relu(prec.mm(h, params[f"fc{i}"]["w"]) + params[f"fc{i}"]["b"])
    return prec.mm(h, params["head"]["w"]) + params["head"]["b"]


def loss(params: Dict[str, Any], batch, cfg: Dict[str, Any], prec: Precision,
         lora: Any = None) -> torch.Tensor:
    images, labels = batch
    return F.cross_entropy(logits(params, images, cfg, prec), labels.long())
