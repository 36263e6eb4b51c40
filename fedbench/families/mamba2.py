"""The ``mamba2`` family: an attention-free Mamba-2 LM (SSD blocks, Dao &
Gu, arXiv:2405.21060) federated over silos of token sequences.

Weights: the system's stacked layout (``layers/{norm, mamba/{in_proj,
conv_w, conv_b, dt_bias, A_log, D, norm_scale, out_proj}}``, ``embed``,
``final_norm``) at the configuration's widths.  The projections, the
convolution and the norm scales are in the parameter dtype, each
projection N(0, 1/fan_in), ``conv_w`` N(0, 1/sqrt(d_conv)), ``conv_b``
zeros, the scales ones and the tied embedding N(0, 0.02); ``A_log``,
``dt_bias`` and ``D`` are float32, drawn as Mamba-2 draws them:
A = U(1, 16), dt = exp U(log 1e-3, log 1e-1) floored at 1e-4 with
``dt_bias`` its inverse softplus, D ones.  The vocabulary's rows are
padded to a multiple of ``pad_vocab_size_multiple``.

Data: the ``olmo`` family's Markov-chain token silos over the unpadded
vocabulary.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .olmo import make_silos  # noqa: F401  (the family's silos)
from .silos import generator, make_weights

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def padded_vocab(cfg: Dict[str, Any]) -> int:
    m = cfg["pad_vocab_size_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def widths(cfg: Dict[str, Any]) -> Dict[str, int]:
    """d_inner E, SSD heads H, head size P, state N, conv width K."""
    E = cfg["expand"] * cfg["d_model"]
    return {"E": E, "H": E // cfg["headdim"], "P": cfg["headdim"], "N": cfg["d_state"],
            "K": cfg["d_conv"]}


def weight_spec(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    if cfg["ngroups"] != 1:
        raise ValueError("the system's SSD takes one B/C group")
    L, D = cfg["n_layer"], cfg["d_model"]
    E, H, N, K = (widths(cfg)[k] for k in ("E", "H", "N", "K"))
    dt, f32 = _DTYPES[cfg["param_dtype"]], torch.float32
    conv = E + 2 * N
    mamba = {"in_proj": ((L, D, 2 * E + 2 * N + H), 1 / math.sqrt(D), dt),
             "conv_w": ((L, K, conv), 1 / math.sqrt(K), dt), "conv_b": ((L, conv), 0.0, dt),
             "dt_bias": ((L, H), 0.0, f32), "A_log": ((L, H), 0.0, f32), "D": ((L, H), 0.0, f32),
             "norm_scale": ((L, E), 0.0, dt), "out_proj": ((L, E, D), 1 / math.sqrt(E), dt)}
    return {"embed": {"embedding": ((padded_vocab(cfg), D), 0.02, dt)},
            "layers": {"norm": {"scale": ((L, D), 0.0, dt)}, "mamba": mamba},
            "final_norm": {"scale": ((D,), 0.0, dt)}}


def make_params(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: Any) -> Dict[str, Any]:
    p = make_weights(weight_spec(cfg, traffic), seed, device)
    m = p["layers"]["mamba"]
    for scale in (p["layers"]["norm"]["scale"], m["norm_scale"], p["final_norm"]["scale"], m["D"]):
        scale.fill_(1.0)
    g = generator(seed, 2, device)
    shape = m["A_log"].shape
    m["A_log"].copy_(torch.log(1.0 + 15.0 * torch.rand(shape, generator=g, device=device)))
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=g, device=device)).clamp_min(1e-4)
    m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    return p


def program_fns(cfg: Dict[str, Any], traffic: Dict[str, Any]):
    """The system's loss and evaluation functions for FLClient."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import get_model

    model = get_model(ModelConfig(
        name=cfg["name"], arch_type="ssm", n_layers=cfg["n_layer"], d_model=cfg["d_model"],
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=padded_vocab(cfg), ssm_state=cfg["d_state"],
        ssm_conv=cfg["d_conv"], ssm_expand=cfg["expand"], ssm_head_dim=cfg["headdim"],
        ssm_chunk=cfg["chunk_size"], norm_type="rmsnorm", tie_embeddings=cfg["tie_embeddings"],
        dtype=cfg["compute_dtype"], param_dtype=cfg["param_dtype"],
        optimizer_state_dtype=cfg["optimizer"]["state_dtype"]))

    def loss_fn(p, b):
        return model.loss(p, {"tokens": b[0], "labels": b[1]})

    def eval_fn(p, b):
        return {"loss_sum": loss_fn(p, b) * b[0].shape[0]}

    return loss_fn, eval_fn


def round_work(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    """What one round must compute, from the cell's shapes alone: the SSD
    scan calls (train steps and evaluation forwards, each a layer), the
    tokens the model steps take, and the fold's input."""
    batch, S = traffic["batch"], traffic["context"]
    steps = sum(-(-n_tr // batch) for n_tr, _ in traffic["silos"]) * traffic["local_epochs"]
    evals = sum(-(-n_te // batch) for _, n_te in traffic["silos"])
    w = widths(cfg)
    shape = {"B": batch, "L": S, "H": w["H"], "P": w["P"], "N": w["N"],
             "chunk": cfg["chunk_size"], "itemsize": _DTYPES[cfg["compute_dtype"]].itemsize}
    return {"ssd": {"shape": shape, "train_calls": steps * cfg["n_layer"],
                    "eval_calls": evals * cfg["n_layer"]},
            "tokens": {"train": sum(n for n, _ in traffic["silos"]) * S * traffic["local_epochs"],
                       "eval": sum(n for _, n in traffic["silos"]) * S}}

