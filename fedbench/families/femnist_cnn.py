"""The ``femnist_cnn`` family: the paper's FEMNIST CNN federated over
silos of 28 x 28 images.

Weights: the system's layout (HWIO kernels, dense (in, out)), float32,
He-normal (std sqrt(2 / fan_in)), biases zero.

Data: class-conditional Gaussian blobs (a center per class, N(0, 0.5),
plus N(0, 0.3) noise a pixel); each silo draws its labels from its own
Dirichlet(0.5) mix over the classes (label skew across silos, as LEAF's
FEMNIST writers have).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from .silos import Silo, generator, make_weights, split_rows, sub_seed


def weight_spec(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    f32 = torch.float32

    def conv(k, c_in, c_out):
        return {"w": ((k, k, c_in, c_out), math.sqrt(2 / (k * k * c_in)), f32), "b": ((c_out,), 0.0, f32)}

    def dense(n_in, n_out):
        return {"w": ((n_in, n_out), math.sqrt(2 / n_in), f32), "b": ((n_out,), 0.0, f32)}

    spec = {"conv1": conv(5, 1, 32), "conv2": conv(5, 32, 64)}
    widths = [(cfg["image_size"] // 4) ** 2 * 64] + [cfg["fc_width"]] * cfg["n_fc"]
    for i in range(cfg["n_fc"]):
        spec[f"fc{i}"] = dense(widths[i], widths[i + 1])
    spec["head"] = dense(widths[-1], cfg["n_classes"])
    return spec


def make_params(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: Any) -> Dict[str, Any]:
    return make_weights(weight_spec(cfg, traffic), seed, device)


def make_silos(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: Any) -> List[Silo]:
    C, side = cfg["n_classes"], cfg["image_size"]
    sizes = traffic["silos"]
    g = generator(seed, 1, device)
    centers = torch.randn((C, side, side, 1), generator=g, device=device) * 0.5
    mixes = np.random.default_rng(sub_seed(seed, 2)).dirichlet(np.full(C, 0.5), size=len(sizes))
    labels = torch.cat([
        torch.multinomial(torch.as_tensor(mix, dtype=torch.float32, device=device), a + b,
                          replacement=True, generator=g)
        for mix, (a, b) in zip(mixes, sizes)])
    images = centers[labels] + 0.3 * torch.randn((labels.numel(), side, side, 1),
                                                  generator=g, device=device)
    return split_rows(images, labels, sizes)


def program_fns(cfg: Dict[str, Any], traffic: Dict[str, Any]):
    """The system's loss and evaluation functions for FLClient."""
    from repro_torch.models.fl_models import FemnistConfig, femnist_forward, softmax_cross_entropy

    fc = FemnistConfig(n_classes=cfg["n_classes"], image_size=cfg["image_size"],
                       n_fc=cfg["n_fc"], fc_width=cfg["fc_width"])

    def loss_fn(p, b):
        return softmax_cross_entropy(femnist_forward(p, b[0], fc), b[1])

    def eval_fn(p, b):
        logits = femnist_forward(p, b[0], fc)
        n = b[0].shape[0]
        return {"acc_sum": (logits.argmax(-1) == b[1]).float().mean() * n,
                "loss_sum": softmax_cross_entropy(logits, b[1]) * n}

    return loss_fn, eval_fn


def round_work(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    """The samples one round trains and evaluates."""
    return {"samples": {"train": sum(n for n, _ in traffic["silos"]) * traffic["local_epochs"],
                        "eval": sum(n for _, n in traffic["silos"])}}
