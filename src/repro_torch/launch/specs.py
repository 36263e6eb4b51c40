"""Input specs, the port of ``repro/launch/specs.py``: ``meta`` tensors
standing in for every model input (the right shape and dtype, no
allocation) plus the matching :class:`~repro_torch.sharding.rules.PartitionSpec`
trees.  The reference returns ``jax.ShapeDtypeStruct``s; a ``meta`` tensor
is the port's counterpart.

Stub frontends: the VLM's patch embeddings and the audio model's frame
embeddings appear here as precomputed-embedding inputs of the right shape.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import InputShape, ModelConfig
from ..sharding.rules import P, PartitionSpec, _map_specs, batch_specs, cache_specs

Specs = Tuple[Dict[str, torch.Tensor], Dict[str, PartitionSpec]]


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(model: Any) -> Any:
    """The model's parameter tree on the ``meta`` device: shapes and
    dtypes, nothing drawn or allocated (the generator stays a CPU one: a
    ``meta`` generator does not exist)."""
    return model.init(torch.Generator(), "meta")


def train_input_specs(
    cfg: ModelConfig, shape: InputShape, pod_axis: bool = False,
    n_pods: int = 1, local_steps: int = 1,
) -> Specs:
    """Batch stand-ins for train_step (single-pod) or fl_round_step
    (multi-pod: leading (n_pods, local_steps) dims)."""
    B, S = shape.global_batch, shape.seq_len
    if pod_axis:
        lead: Tuple[int, ...] = (n_pods, local_steps, B // n_pods)
    else:
        lead = (B,)
    specs: Dict[str, torch.Tensor] = {
        "tokens": _meta(lead + (S,), torch.int32),
        "labels": _meta(lead + (S,), torch.int32),
    }
    if cfg.arch_type == "vlm":
        specs["patch_embeds"] = _meta(lead + (cfg.n_image_tokens, cfg.d_model),
                                      cfg.activation_dtype)
    if cfg.arch_type == "encdec":
        specs["frames"] = _meta(lead + (cfg.encoder_seq, cfg.d_model), cfg.activation_dtype)
    shardings = batch_specs(cfg, shape, pod_axis=pod_axis)
    if pod_axis:
        # (pod, step, batch, ...): step unsharded.
        shardings = {k: P(v[0], None, *v[1:]) for k, v in shardings.items()}
    return specs, shardings


def prefill_input_specs(cfg: ModelConfig, shape: InputShape, pod_axis: bool = False) -> Specs:
    """Prefill processes the full prompt; multi-pod serving shards the
    request batch over (pod, data) — pods are serving replicas."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {"tokens": _meta((B, S), torch.int32)}
    batch_axes: Any = ("pod", "data") if pod_axis else "data"
    shardings: Dict[str, PartitionSpec] = {"tokens": P(batch_axes, None)}
    if cfg.arch_type == "vlm":
        specs["patch_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_model), cfg.activation_dtype)
        shardings["patch_embeds"] = P(batch_axes, None, None)
    if cfg.arch_type == "encdec":
        specs["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), cfg.activation_dtype)
        shardings["frames"] = P(batch_axes, None, None)
    return specs, shardings


def decode_input_specs(cfg: ModelConfig, shape: InputShape, pod_axis: bool = False) -> Specs:
    """Token + position for serve_step (ONE new token against a seq_len
    KV cache)."""
    B = shape.global_batch
    long_ctx = B < 2
    if long_ctx:
        batch_spec = None
    else:
        batch_spec = ("pod", "data") if pod_axis else "data"
    specs = {"token": _meta((B, 1), torch.int32), "pos": _meta((), torch.int32)}
    shardings = {"token": P(batch_spec, None), "pos": P()}
    return specs, shardings


def abstract_cache(model: Any, cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """The decode cache on the ``meta`` device (no allocation)."""
    return model.init_cache(shape.global_batch, shape.seq_len, device="meta")


def decode_cache_specs(cfg: ModelConfig, shape: InputShape, cache_abs: Any,
                       pod_axis: bool = False) -> Any:
    """Cache specs; multi-pod decode adds "pod" to whatever axis carries
    the batch (decode_32k) or the KV sequence (long_500k)."""
    specs = cache_specs(cfg, shape, cache_abs)
    if not pod_axis:
        return specs
    long_ctx = shape.global_batch < 2

    def upgrade(p: PartitionSpec) -> PartitionSpec:
        dims = list(p)
        for i, d in enumerate(dims):
            if not long_ctx and d == "data":
                dims[i] = ("pod", "data")
                break
            if long_ctx and d == ("data", "model"):
                dims[i] = ("pod", "data", "model")
                break
        return P(*dims)

    return _map_specs(upgrade, specs)
