"""Sharding rules, the port of ``repro/sharding/rules.py``: map every
parameter / batch / cache leaf to a :class:`PartitionSpec` for the (data,
model) mesh, with an optional leading "pod" axis for the federated
multi-pod step.

Parameters get 2D sharding (tensor-parallel over "model" + FSDP over
"data") chosen per leaf by a deterministic rule:

  1. stacked-layer leading axes (paths containing layers/superblocks/
     dense_layers/encoder/decoder) are never sharded (the layer loop runs
     over them);
  2. routed-expert tensors (leading dim == n_experts) put the expert dim on
     "model" — expert parallelism;
  3. otherwise the largest divisible dim goes to "model", the next largest
     divisible dim to "data" (FSDP);
  4. vectors (norm scales, biases, 1-D stats) replicate.

Caches: decode_32k shards batch over "data" and the KV sequence over
"model" (context parallelism — GQA KV-head counts are smaller than the
model axis, so heads cannot carry it); long_500k (batch=1) shards the KV
sequence over BOTH axes. SSM states shard heads over "model".

The specs are the port's own immutable :class:`PartitionSpec`, a tuple of
axis names, ``None`` or tuples of names; as a tuple it equals the
reference's ``jax.sharding.PartitionSpec`` for the same leaf.  The rules
read only the mesh's axis sizes (:func:`~repro_torch.sharding.context.axis_sizes`).
:func:`to_named` turns specs into ``torch.distributed.tensor`` placements
on a ``DeviceMesh`` and :func:`distribute` places a tree by them.

Trees are walked as the reference walks its pytrees: dicts in sorted-key
order, lists and tuples by index, and a ``NamedTuple`` (an optimizer
state) by field, whose path part is ``.name`` as ``str`` of JAX's
``GetAttrKey`` gives it.  A leaf is anything with a ``shape``; any other
value (the port's optimizer ``step`` is a Python ``int``) has no
placement and is carried through unchanged.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Tuple

from ..configs.base import InputShape, ModelConfig
from .context import axis_sizes

_STACKED = re.compile(r"(layers|superblocks|dense_layers|encoder|decoder)(/|$)")


class PartitionSpec(tuple):
    """One leaf's sharding: for each tensor dim an axis name, ``None``
    (unsharded) or a tuple of names (split over those mesh axes, major to
    minor)."""

    def __new__(cls, *dims: Any) -> "PartitionSpec":
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_path(fn: Callable[[str, Any], Any], tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn("a/0/w", leaf)`` for every leaf, the tree's structure kept."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, v, path + ("." + f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if hasattr(tree, "shape"):
        return fn("/".join(path), tree)
    return tree


def _map_specs(fn: Callable[..., Any], specs: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` for every :class:`PartitionSpec` of ``specs``
    and the values at the same place in ``trees``; anything that is not a
    spec is taken from the first tree (or ``specs``) as it is."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], *(t[k] for t in trees)) for k in specs}
    if _is_namedtuple(specs):
        return type(specs)(*(_map_specs(fn, s, *xs) for s, *xs in zip(specs, *trees)))
    if isinstance(specs, (list, tuple)):
        out = [_map_specs(fn, s, *xs) for s, *xs in zip(specs, *trees)]
        return out if isinstance(specs, list) else tuple(out)
    return trees[0] if trees else specs


# Column-parallel (Megatron): input dim gets FSDP "data", output dim gets
# tensor-parallel "model" — activations come out feature-sharded.
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "w1", "in_proj"}
# Row-parallel: contraction dim on "model" (partial sums -> psum), output
# dim FSDP "data".
_ROW_PARALLEL = {"wo", "w_down", "w2", "out_proj"}
_REPLICATED = {"router", "dec_pos", "conv_w", "conv_b", "dt_bias", "A_log", "D",
               "norm_scale", "scale", "bias", "b1", "b2", "b"}


def _assign(dims, shape, idx, axis, size) -> bool:
    """Put `axis` on dims[idx] if divisible and slot free."""
    if dims[idx] is None and shape[idx] % size == 0 and shape[idx] >= size:
        dims[idx] = axis
        return True
    return False


def _leaf_spec(
    path: str,
    shape: Tuple[int, ...],
    cfg: ModelConfig,
    data: int,
    model: int,
    pod_axis: bool,
) -> PartitionSpec:
    """The per-leaf rule. `pod_axis` adds a leading 'pod' dim (stacked
    federated replicas)."""
    dims: list = [None] * len(shape)
    start = 0
    if pod_axis:
        dims[0] = "pod"
        start = 1

    rest = list(range(start, len(shape)))
    if _STACKED.search(path) and rest:
        rest = rest[1:]  # skip the scan axis

    name = path.rsplit("/", 1)[-1]

    if len(rest) < 2 or name in _REPLICATED:
        return P(*dims)  # vectors / small tables replicate

    # Expert parallelism: routed-expert tensors (E, D, F) / (E, F, D).
    if cfg.n_experts > 0 and shape[rest[0]] == cfg.n_experts and len(rest) >= 3:
        dims[rest[0]] = "model"
        for i in sorted(rest[1:], key=lambda i: -shape[i]):
            if _assign(dims, shape, i, "data", data):
                break
        return P(*dims)

    first, last = rest[0], rest[-1]
    if name in _COL_PARALLEL:
        _assign(dims, shape, last, "model", model)
        _assign(dims, shape, first, "data", data)
        return P(*dims)
    if name in _ROW_PARALLEL:
        _assign(dims, shape, first, "model", model)
        _assign(dims, shape, last, "data", data)
        return P(*dims)
    if name == "embedding":
        # (V, D): vocab tensor-parallel, D FSDP.
        _assign(dims, shape, first, "model", model)
        _assign(dims, shape, last, "data", data)
        return P(*dims)
    if name == "w" and len(rest) == 2:
        # lm_head (D, V): vocab tensor-parallel -> logits vocab-sharded.
        _assign(dims, shape, last, "model", model)
        _assign(dims, shape, first, "data", data)
        return P(*dims)

    # Fallback: largest divisible dim -> model, next -> data, never the
    # same dim twice.
    by_size = sorted(rest, key=lambda i: -shape[i])
    for i in by_size:
        if _assign(dims, shape, i, "model", model):
            break
    for i in by_size:
        if _assign(dims, shape, i, "data", data):
            break
    return P(*dims)


def param_specs(params: Any, cfg: ModelConfig, mesh: Any, pod_axis: bool = False) -> Any:
    """At-rest parameter shardings.

    Without cfg.fsdp, weights shard on "model" only (activations own the
    "data" axis); routed-expert tensors are always 2D (expert@model +
    data) since the expert dim never clashes with the batch axis. With
    cfg.fsdp, weights also shard over "data" at rest."""
    sizes = axis_sizes(mesh)
    data, model = sizes["data"], sizes["model"]

    def f(path, leaf):
        shape = tuple(leaf.shape)
        spec = _leaf_spec(path, shape, cfg, data, model, pod_axis)
        if not cfg.fsdp:
            # keep "data" only on expert tensors (expert rule is conflict-free)
            is_expert = (
                cfg.n_experts > 0
                and any(d == cfg.n_experts for d in shape[:3])
                and len(shape) >= 3
            )
            if not is_expert:
                spec = P(*[d if d != "data" else None for d in spec])
        return spec

    return _map_with_path(f, params)


def compute_specs(params: Any, cfg: ModelConfig, mesh: Any) -> Any:
    """Per-layer compute-time shardings: the at-rest spec with "data"
    stripped (what an FSDP layer loop gathers each slice to)."""
    sizes = axis_sizes(mesh)
    data, model = sizes["data"], sizes["model"]

    def f(path, leaf):
        spec = _leaf_spec(path, tuple(leaf.shape), cfg, data, model, False)
        return P(*[d if d == "model" else None for d in spec])

    return _map_with_path(f, params)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: InputShape, pod_axis: bool = False) -> Dict[str, PartitionSpec]:
    """Input shardings. Batch over "data" (plus leading "pod" for the
    federated step, where the global batch has a pod dim)."""
    lead = ("pod",) if pod_axis else ()
    bspec = lead + ("data",)
    out: Dict[str, PartitionSpec] = {
        "tokens": P(*bspec, None),
        "labels": P(*bspec, None),
    }
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = P(*bspec, None, None)
    if cfg.arch_type == "encdec":
        out["frames"] = P(*bspec, None, None)
    return out


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, shape: InputShape, cache: Any) -> Any:
    """PartitionSpecs for the decode cache tree.

    decode_32k: batch -> data, KV seq -> model (context parallel).
    long_500k:  batch=1 -> KV seq over (data, model) both.
    """
    long_ctx = shape.global_batch < 2  # long_500k: nothing else to shard

    def div(leaf, idx, axis_size) -> bool:
        return leaf.shape[idx] % axis_size == 0 and leaf.shape[idx] >= axis_size

    def f(p, leaf):
        nd = len(leaf.shape)
        # mesh sizes for the production mesh (16, 16): divisibility checks
        # use 16, whatever mesh the specs are later placed on.
        M, D = 16, 16
        if "scale" in p:
            # int8-cache scales (L, B, S, KV): batch or seq carries "data".
            if long_ctx:
                return P(None, None, "data", None)
            return P(None, "data", None, None)
        if p.startswith("k") or p.startswith("v"):
            if "cross" in p:
                # (L, B, T_enc, KV, HD): only batch shards.
                return P(None, "data" if div(leaf, 1, D) else None, None, None, None)
            # The written seq dim stays UNSHARDED for decode_32k (a write
            # into a seq-sharded cache would replicate the cache).  The
            # model axis carries KV heads when divisible, else head_dim.
            if cfg.arch_type == "hybrid":
                # (SB, A, B, S, KV, HD)
                kv_ok = div(leaf, 4, M)
                head = ("model" if kv_ok else None, None if kv_ok else "model")
                if long_ctx:
                    return P(None, None, None, "data", *head)
                return P(None, None, "data", None, *head)
            # (L, B, S, KV, HD)
            kv_ok = div(leaf, 3, M)
            head = ("model" if kv_ok else None, None if kv_ok else "model")
            if long_ctx:
                return P(None, None, "data", *head)
            return P(None, "data", None, *head)
        if p.startswith("ssm"):
            # heads dim shards over "model" only when divisible; otherwise
            # fall back to the SSD head_dim (P) which is 128-multiple.
            if cfg.arch_type == "hybrid":
                # (SB, M, B, H, P, N)
                h_ok = div(leaf, 3, M)
                return P(None, None, None if long_ctx else "data",
                         "model" if h_ok else None,
                         None if h_ok else ("model" if div(leaf, 4, M) else None),
                         None)
            # (L, B, H, P, N)
            h_ok = div(leaf, 2, M)
            return P(None, None if long_ctx else "data",
                     "model" if h_ok else None,
                     None if h_ok else ("model" if div(leaf, 3, M) else None),
                     None)
        if p.startswith("conv"):
            if cfg.arch_type == "hybrid":
                # (SB, M, B, K, C)
                return P(None, None, None if long_ctx else "data", None,
                         "model" if div(leaf, 4, M) else None)
            # (L, B, K, C)
            return P(None, None if long_ctx else "data", None,
                     "model" if div(leaf, 3, M) else None)
        return P(*([None] * nd))

    return _map_with_path(f, cache)


def decode_token_spec(shape: InputShape) -> PartitionSpec:
    return P(None if shape.global_batch < 2 else "data", None)


# ---------------------------------------------------------------------------
# Placement on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(mesh: Any, spec: PartitionSpec) -> tuple:
    """One spec as ``torch.distributed.tensor`` placements, one a mesh dim:
    ``Shard(i)`` on each mesh dim the spec puts on tensor dim ``i``,
    ``Replicate()`` on the others.  A multi-axis entry such as ``("pod",
    "data")`` shards dim ``i`` on both mesh dims; DTensor splits it over
    them in mesh order, so the entry must name them in that order (JAX
    splits major to minor in the entry's order).  An axis the mesh lacks,
    two dims on one mesh axis, or an entry out of mesh order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec!r} names mesh axis {a!r}; the mesh has {names}")
            j = names.index(a)
            if not isinstance(out[j], Replicate):
                raise ValueError(f"{spec!r} puts two tensor dims on mesh axis {a!r}")
            out[j] = Shard(i)
            idx.append(j)
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: the axes of {entry!r} are not in mesh order {names}")
    return tuple(out)


def to_named(mesh: Any, tree_of_specs: Any) -> Any:
    """Every spec of a tree as its placements on ``mesh`` (a ``DeviceMesh``)."""
    return _map_specs(lambda s: placements(mesh, s), tree_of_specs)


def distribute(tree: Any, mesh: Any, specs: Any) -> Any:
    """Place every tensor of ``tree`` on ``mesh`` by its spec (the tree of
    ``param_specs`` / ``cache_specs`` / ... for it) through
    ``distribute_tensor``; each rank keeps the slice its spec names."""
    from torch.distributed.tensor import distribute_tensor

    return _map_specs(lambda s, t: distribute_tensor(t, mesh, placements(mesh, s)),
                      specs, tree)
