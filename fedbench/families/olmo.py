"""The ``olmo`` family: a dense decoder LM (OLMo) federated over silos of
token sequences.

Weights: the system's stacked layout at the configuration's widths, in
its parameter dtype; each projection N(0, 1/fan_in), the tied embedding
N(0, 0.02).  With ``adapters`` in the traffic, every target gets LoRA
factors: ``a`` N(0, 0.01) and ``b`` zeros, both float32.

Data: one Markov chain over the vocabulary (4 successors a token, drawn
from the seed), each sequence starting at a random token; silos take
consecutive rows, ``context`` tokens a row plus its shifted labels.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from .silos import Silo, generator, make_weights, split_rows

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weight_spec(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    L, D, H, hd, F, V = (cfg[k] for k in ("n_layers", "d_model", "n_heads", "head_dim",
                                           "d_ff", "vocab_size"))
    dt = _DTYPES[cfg["param_dtype"]]
    attn = {"wq": ((L, D, H * hd), 1 / math.sqrt(D), dt), "wk": ((L, D, H * hd), 1 / math.sqrt(D), dt),
            "wv": ((L, D, H * hd), 1 / math.sqrt(D), dt), "wo": ((L, H * hd, D), 1 / math.sqrt(H * hd), dt)}
    lora = traffic.get("adapters")
    if lora:
        for name in lora["targets"]:
            shape = attn[name][0]
            attn[f"{name}.lora_a"] = ((L, shape[1], lora["rank"]), 0.01, torch.float32)
            attn[f"{name}.lora_b"] = ((L, lora["rank"], shape[2]), 0.0, torch.float32)
    mlp = {"w_gate": ((L, D, F), 1 / math.sqrt(D), dt), "w_up": ((L, D, F), 1 / math.sqrt(D), dt),
           "w_down": ((L, F, D), 1 / math.sqrt(F), dt)}
    return {"embed": {"embedding": ((V, D), 0.02, dt)},
            "layers": {"attn": attn, "mlp": mlp}}


def make_params(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: Any) -> Dict[str, Any]:
    p = make_weights(weight_spec(cfg, traffic), seed, device)
    # The non-parametric norms hold no leaves; the system's tree keeps
    # their empty dicts in place.
    p["layers"].update(norm1={}, norm2={})
    p["final_norm"] = {}
    return p


def make_silos(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: Any) -> List[Silo]:
    V, S = cfg["vocab_size"], traffic["context"]
    sizes = traffic["silos"]
    rows = sum(a + b for a, b in sizes)
    g = generator(seed, 1, device)
    succ = torch.randint(0, V, (V, 4), generator=g, device=device)
    picks = torch.randint(0, 4, (rows, S), generator=g, device=device)
    toks = torch.empty((rows, S + 1), dtype=torch.long, device=device)
    toks[:, 0] = torch.randint(0, V, (rows,), generator=g, device=device)
    for t in range(S):
        toks[:, t + 1] = succ[toks[:, t], picks[:, t]]
    return split_rows(toks[:, :-1], toks[:, 1:], sizes)


def program_fns(cfg: Dict[str, Any], traffic: Dict[str, Any]):
    """The system's loss and evaluation functions for FLClient."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import get_model
    from repro_torch.models.fl_models import LoRAConfig, lora_effective

    lora = traffic.get("adapters")
    mc = ModelConfig(
        name=cfg["name"], arch_type="dense", n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_heads"], d_ff=cfg["d_ff"],
        vocab_size=cfg["vocab_size"], head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"],
        norm_type="nonparametric", tie_embeddings=True, dtype=cfg["compute_dtype"],
        param_dtype=cfg["param_dtype"], optimizer_state_dtype=cfg["optimizer"]["state_dtype"])
    model = get_model(mc)
    lcfg = (LoRAConfig(rank=lora["rank"], alpha=lora["alpha"], targets=tuple(lora["targets"]))
            if lora else None)

    def loss_fn(p, b):
        return model.loss(lora_effective(p, lcfg) if lcfg else p, {"tokens": b[0], "labels": b[1]})

    def eval_fn(p, b):
        return {"loss_sum": loss_fn(p, b) * b[0].shape[0]}

    return loss_fn, eval_fn


def round_work(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, Any]:
    """What one round must compute, from the cell's shapes alone: the
    attention calls (train steps and evaluation forwards, each a layer),
    the tokens the model steps take, and the fold's input."""
    batch, S = traffic["batch"], traffic["context"]
    steps = sum(-(-n_tr // batch) for n_tr, _ in traffic["silos"]) * traffic["local_epochs"]
    evals = sum(-(-n_te // batch) for _, n_te in traffic["silos"])
    shape = {"B": batch, "S": S, "H": cfg["n_heads"], "D": cfg["head_dim"], "causal": True}
    return {"attention": {"shape": shape, "train_calls": steps * cfg["n_layers"],
                          "eval_calls": evals * cfg["n_layers"]},
            "tokens": {"train": sum(n for n, _ in traffic["silos"]) * S * traffic["local_epochs"],
                       "eval": sum(n for _, n in traffic["silos"]) * S}}
