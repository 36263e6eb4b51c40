"""Fused FedAvg aggregation engine — the server's per-round hot path.

The port of ``repro/federated/agg_engine.py``.  At cross-silo model sizes the FedAvg
reduce is a pure memory-bound stream, so the engine's job is to touch
every client byte once per round.  The barrier round (``aggregate``):

  flatten-once — each client tree is raveled through a cached
      :class:`RavelPlan` (leaf order, shapes and dtypes computed once per
      model structure) into one fp32 ``(N, L)`` buffer;
  reduce       — the buffer goes to ``kernels.fedavg_reduce``, which
      launches the hand-written CUDA kernel for a CUDA buffer and runs the
      plain PyTorch version for a CPU one;
  unflatten    — the ``(L,)`` result is cut back into the tree, each leaf
      cast to its dtype.

The buffer's rows sit ``RavelPlan.row_stride`` elements apart, ``L``
rounded up to a multiple of ``BLOCK`` = 8192, so every row starts
16-byte aligned and the kernel streams it with 16-byte loads.  The
tail of each row is never written or read.  (At the paper's FEMNIST
width ``L % 4 == 2``: a contiguous ``(N, L)`` buffer would misalign
every odd row.)  A chunked mode (``reduce_flat(..., chunk_elems=...)``)
reduces column blocks one at a time.  ``fused_stacked_tree_reduce``
reduces a tree whose leaves carry a leading client axis the same way.

The async round (``streaming``) folds clients one at a time into a
:class:`StreamingAggregator`: O(L) accumulator memory, never an
``(N, L)`` gather.  With a delta base (flat mode) it folds compressed
updates straight into its fp32 accumulator: int8 and fp16 payloads
through the ``dequant_fold`` kernel, top-k payloads with ``index_add_``.
Late updates wait in a :class:`CarryOverBuffer` for the next round's
fold, discounted by a :class:`StalenessPolicy`.

Structured updates (``streaming(schema=...)``) name parameter groups of
one model (:class:`UpdateSchema`); a :class:`StructuredStreamingAggregator`
keeps one padded fp32 accumulator per group, so a federated-LoRA round
folds only the adapters' elements (int8 and fp16 group deltas through
``dequant_fold``) and the frozen base comes back untouched.

Partial sums (``export_partial``/``fold_partial``) carry a fold between
the levels of the aggregation hierarchy: a region exports its padded
accumulator, weight total and client count as a :class:`PartialSum`
(per group, a :class:`StructuredPartialSum`), and a parent adds it into
its own accumulator in place.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import (
    Any, Callable, ClassVar, Dict, List, Mapping, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

from ..kernels.dequant_fold import dequant_fold, f32_scalar
from ..kernels.fedavg_reduce import BLOCK, fedavg_reduce
from ..utils.tree import (
    TreeDef,
    keystr,
    path_str,
    tree_flatten,
    tree_flatten_with_path,
    tree_unflatten,
)
from .compression import QBLOCK, CompressedUpdate


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Ravel plans: flatten/unflatten layout computed once per model structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RavelPlan:
    """Cached flatten/unflatten layout for one tree structure.

    ``flatten_stack`` ravels a *list* of N structurally-identical trees
    into one fp32 ``(N, L)`` buffer (rows ``row_stride`` apart);
    ``unflatten`` restores an ``(L,)`` vector to the original structure,
    shapes, and per-leaf dtypes (the leaves are views into the vector).
    ``signature`` is a stable digest of the structure key — equal to the
    reference's signature for the same tree, since the key's ``repr``
    (treedef, shapes, dtype names) is written the same way.
    """

    treedef: TreeDef
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    total_elems: int
    signature: str
    row_stride: int

    def _check(self, tree: Any, index: int) -> List[torch.Tensor]:
        mismatch = _first_structure_mismatch(self.treedef, self.shapes, tree)
        if mismatch is not None:
            where, detail = mismatch
            raise StructureMismatchError(f"update {index} at leaf {where!r}: {detail}",
                                         path=where)
        return tree_flatten(tree)[0]

    def flatten(self, tree: Any) -> torch.Tensor:
        """One tree -> contiguous fp32 ``(L,)``."""
        leaves = self._check(tree, 0)
        return torch.cat([leaf.reshape(-1).float() for leaf in leaves])

    def flatten_stack(self, trees: Sequence[Any]) -> torch.Tensor:
        """N trees -> fp32 ``(N, L)`` view of an ``(N, row_stride)`` buffer."""
        if not trees:
            raise ValueError("flatten_stack needs at least one tree")
        first = tree_flatten(trees[0])[0][0]
        buf = torch.empty((len(trees), self.row_stride), dtype=torch.float32,
                          device=first.device)
        for i, tree in enumerate(trees):
            off = 0
            for leaf, size in zip(self._check(tree, i), self.sizes):
                buf[i, off:off + size].copy_(leaf.reshape(-1))
                off += size
        return buf[:, :self.total_elems]

    def unflatten(self, vec: torch.Tensor) -> Any:
        outs = []
        off = 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            outs.append(vec[off:off + size].reshape(shape).to(dtype))
            off += size
        return tree_unflatten(self.treedef, outs)


# Bounded LRU: multi-model serving churns tree structures, so an unbounded
# module-global would grow forever.  Hits move the plan to the back;
# inserts evict from the front.  Plans held by callers survive eviction.
_PLAN_CACHE: "OrderedDict[Any, RavelPlan]" = OrderedDict()
_PLAN_CACHE_MAX: int = 64


def _structure_key(tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return (
        treedef,
        tuple(tuple(leaf.shape) for leaf in leaves),
        tuple(_dtype_name(leaf.dtype) for leaf in leaves),
    )


def clear_plan_cache() -> None:
    """Drop every cached :class:`RavelPlan` (tests / structure churn)."""
    _PLAN_CACHE.clear()


def plan_cache_size() -> int:
    """Number of plans currently cached (bounded by the LRU limit)."""
    return len(_PLAN_CACHE)


def set_plan_cache_limit(max_plans: int) -> int:
    """Set the LRU bound on the plan cache; returns it.  Shrinking below
    the current population evicts oldest-first immediately."""
    global _PLAN_CACHE_MAX
    if max_plans < 1:
        raise ValueError("plan cache limit must be >= 1")
    _PLAN_CACHE_MAX = int(max_plans)
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return _PLAN_CACHE_MAX


def plan_for(tree: Any) -> RavelPlan:
    """Return the (LRU-cached) RavelPlan for ``tree``'s structure."""
    key = _structure_key(tree)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
        return plan

    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot build a ravel plan for an empty tree")
    shapes = key[1]
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    total = int(sum(sizes))
    plan = RavelPlan(
        treedef=treedef,
        shapes=shapes,
        dtypes=tuple(leaf.dtype for leaf in leaves),
        sizes=sizes,
        total_elems=total,
        signature=hashlib.sha1(repr(key).encode()).hexdigest()[:16],
        row_stride=-(-total // BLOCK) * BLOCK,
    )
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return plan


class StructureMismatchError(ValueError):
    """A client's update tree diverges from the fold's structure.

    Carries the offending ``client_id`` (when the caller supplied one)
    and the first mismatching leaf ``path``."""

    def __init__(
        self,
        message: str,
        client_id: Optional[str] = None,
        path: Optional[str] = None,
    ) -> None:
        super().__init__(message)
        self.client_id = client_id
        self.path = path


def _leaf_paths(treedef: TreeDef) -> List[str]:
    """The path string of every leaf slot of a treedef."""
    dummy = tree_unflatten(treedef, list(range(treedef.num_leaves)))
    return [path_str(p) or "<root>" for p, _ in tree_flatten_with_path(dummy)[0]]


def _first_structure_mismatch(
    ref_treedef: TreeDef,
    ref_shapes: Tuple[Tuple[int, ...], ...],
    params: Any,
) -> Optional[Tuple[str, str]]:
    """``(leaf path, detail)`` of the first divergence, or None if the
    update matches the reference treedef + leaf shapes (dtypes are NOT
    compared: mixed-precision clients fold through the fp32 cast)."""
    leaves, treedef = tree_flatten(params)
    shapes = tuple(tuple(np.shape(leaf)) for leaf in leaves)
    if treedef == ref_treedef:
        if shapes == ref_shapes:
            return None
        for path, got, want in zip(_leaf_paths(treedef), shapes, ref_shapes):
            if got != want:
                return path, f"leaf shape {got} != expected {want}"
        return "<root>", "leaf shapes diverge"
    ref_paths = _leaf_paths(ref_treedef)
    got_paths = _leaf_paths(treedef)
    for rp, gp in zip(ref_paths, got_paths):
        if rp != gp:
            return gp, f"unexpected leaf (expected {rp} here)"
    if len(got_paths) != len(ref_paths):
        longer = got_paths if len(got_paths) > len(ref_paths) else ref_paths
        extra = longer[min(len(got_paths), len(ref_paths))]
        kind = "extra" if len(got_paths) > len(ref_paths) else "missing"
        return extra, (
            f"{kind} leaf: update has {len(got_paths)} leaves, "
            f"expected {len(ref_paths)}"
        )
    return "<root>", f"treedef {treedef} != expected {ref_treedef}"


def _raise_structure_mismatch(mismatch: Tuple[str, str], client_id: Optional[str]) -> None:
    path, detail = mismatch
    who = f"client {client_id!r}" if client_id is not None else "an update"
    raise StructureMismatchError(
        f"update from {who} does not match the fold's tree structure "
        f"at leaf {path!r}: {detail}",
        client_id=client_id,
        path=path,
    )


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Update schemas: named parameter groups over one model structure
# ---------------------------------------------------------------------------

def _leaf_keystrs(treedef: TreeDef) -> List[str]:
    """Every leaf slot's path in the reference's ``keystr`` form, which
    schema selectors are matched against."""
    dummy = tree_unflatten(treedef, list(range(treedef.num_leaves)))
    return [keystr(p) or "<root>" for p, _ in tree_flatten_with_path(dummy)[0]]


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """Cached flatten layout for one named subset of a tree's leaves.

    The structured analogue of :class:`RavelPlan`: ``flatten`` ravels the
    *selected* leaves of a full tree (in full-plan leaf order) into one
    compact fp32 ``(total_elems,)`` vector; ``starts[j]`` is where leaf
    ``leaf_indices[j]`` begins in it.  ``padded_len`` rounds the compact
    length up to the kernels' BLOCK (== the compression QBLOCK), so
    per-group int8 / fp16 deltas feed ``dequant_fold`` exactly like
    whole-model ones.  ``signature`` digests (full-plan signature, leaf
    indices), as the reference's does, so the two packages agree on it."""

    leaf_indices: Tuple[int, ...]
    sizes: Tuple[int, ...]
    total_elems: int
    padded_len: int
    signature: str
    starts: Tuple[int, ...]
    full_sizes: Tuple[int, ...]

    def flatten(self, tree: Any) -> torch.Tensor:
        leaves = tree_flatten(tree)[0]
        return torch.cat([leaves[i].reshape(-1).float() for i in self.leaf_indices])

    @property
    def offsets(self) -> np.ndarray:
        """Each compact position's index in the full flat vector (int32, as
        the reference keeps it; built on demand)."""
        full = np.concatenate([np.zeros(1, np.int64), np.cumsum(self.full_sizes, dtype=np.int64)])
        return np.concatenate([np.arange(full[i], full[i] + self.full_sizes[i], dtype=np.int64)
                               for i in self.leaf_indices]).astype(np.int32)


def group_plan_for(tree: Any, leaf_indices: Sequence[int]) -> GroupPlan:
    """The (LRU-cached) :class:`GroupPlan` for a subset of ``tree``'s leaves.

    Cached in the same bounded LRU as full ravel plans, keyed by
    ``(structure, ("group", indices))``: two schemas selecting different
    subtrees of one structure get distinct plans (and signatures), never
    a colliding cache slot; equal partitions get the same object."""
    full = plan_for(tree)
    idx = tuple(sorted(int(i) for i in leaf_indices))
    if not idx:
        raise ValueError("a parameter group must select at least one leaf")
    if len(set(idx)) != len(idx):
        raise ValueError(f"duplicate leaf indices in group selection: {idx}")
    if idx[0] < 0 or idx[-1] >= len(full.sizes):
        raise ValueError(
            f"group leaf indices {idx} out of range for a {len(full.sizes)}-leaf structure"
        )
    key = (_structure_key(tree), ("group", idx))
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_CACHE.move_to_end(key)
        return cached  # type: ignore[return-value]
    sizes = tuple(int(full.sizes[i]) for i in idx)
    total = int(sum(sizes))
    plan = GroupPlan(
        leaf_indices=idx,
        sizes=sizes,
        total_elems=total,
        padded_len=-(-total // BLOCK) * BLOCK,
        signature=hashlib.sha1(f"{full.signature}:group:{idx!r}".encode()).hexdigest()[:16],
        starts=tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)[:-1]])),
        full_sizes=full.sizes,
    )
    _PLAN_CACHE[key] = plan  # type: ignore[assignment]
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
    return plan


def _select_leaves(name: str, selector: Any, tree: Any, paths: Sequence[str]) -> Tuple[int, ...]:
    """Leaf indices a group selector picks out of ``tree``.

    Selector forms: a substring matched against the leaf's key path
    (``"lora_"``), a sequence of substrings (any match), a ``path ->
    bool`` callable, or a boolean mask tree with the same leaf count as
    the model (truthy leaf = selected)."""
    if isinstance(selector, str):
        return tuple(i for i, p in enumerate(paths) if selector in p)
    if isinstance(selector, (list, tuple)) and all(isinstance(s, str) for s in selector):
        toks = list(selector)
        return tuple(i for i, p in enumerate(paths) if any(t in p for t in toks))
    if callable(selector):
        return tuple(i for i, p in enumerate(paths) if bool(selector(p)))
    mask_leaves = tree_flatten(selector)[0]
    if len(mask_leaves) != len(paths):
        raise ValueError(
            f"schema group {name!r}: boolean mask has {len(mask_leaves)} "
            f"leaves, the model has {len(paths)}"
        )
    return tuple(i for i, m in enumerate(mask_leaves) if bool(np.all(np.asarray(m))))


class UpdateSchema:
    """Named parameter groups over one model structure (order preserved).

    Each group names a subset of the model's leaves (see
    :func:`_select_leaves` for the selector forms), and clients may ship
    any subset of the groups: silos absent from a group contribute no
    weight to it.  Groups may overlap; an element covered by several
    groups normalizes by the sum of the covering groups' weight totals.
    ``resolve(tree)`` binds the schema to a concrete structure."""

    def __init__(self, groups: Union[Mapping[str, Any], Sequence[Tuple[str, Any]]]) -> None:
        if isinstance(groups, Mapping):
            items = [(str(n), s) for n, s in groups.items()]
        else:
            items = [(str(n), s) for n, s in groups]
        if not items:
            raise ValueError("an UpdateSchema needs at least one group")
        names = [n for n, _ in items]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate group names in schema: {names}")
        for n, sel in items:
            if sel is None:
                raise ValueError(f"schema group {n!r} has no selector (None)")
        self.groups: Tuple[Tuple[str, Any], ...] = tuple(items)

    @property
    def group_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.groups)

    def __repr__(self) -> str:
        return f"UpdateSchema({', '.join(self.group_names)})"

    def resolve(self, tree: Any) -> "ResolvedSchema":
        """Bind the schema to ``tree``'s structure (per-group plans)."""
        full = plan_for(tree)
        paths = _leaf_keystrs(full.treedef)
        resolved: List[Tuple[str, GroupPlan]] = []
        for name, sel in self.groups:
            idx = _select_leaves(name, sel, tree, paths)
            if not idx:
                raise ValueError(
                    f"schema group {name!r} selects no leaves of the model "
                    f"(selector {sel!r}; leaf paths: {paths[:8]}...)"
                )
            resolved.append((name, group_plan_for(tree, idx)))
        leaf_groups = tuple(
            tuple(n for n, gp in resolved if i in set(gp.leaf_indices))
            for i in range(len(full.sizes))
        )
        signature = hashlib.sha1(
            (full.signature + "".join(f"|{n}:{gp.signature}" for n, gp in resolved)).encode()
        ).hexdigest()[:16]
        return ResolvedSchema(plan=full, groups=tuple(resolved), signature=signature,
                              leaf_groups=leaf_groups)


def as_update_schema(spec: Union[None, UpdateSchema, Mapping[str, Any]]) -> Optional[UpdateSchema]:
    """Coerce a user-facing schema knob into an :class:`UpdateSchema`:
    ``None`` (off), an existing schema, or a mapping of group name ->
    selector; ``ValueError`` on anything else."""
    if spec is None:
        return None
    if isinstance(spec, UpdateSchema):
        return spec
    if isinstance(spec, Mapping):
        return UpdateSchema(spec)
    raise ValueError(
        f"schema must be None, an UpdateSchema, or a mapping of group "
        f"name -> selector; got {type(spec).__name__}"
    )


@dataclasses.dataclass(frozen=True)
class ResolvedSchema:
    """An :class:`UpdateSchema` bound to one concrete model structure.

    ``leaf_groups[i]`` names the groups covering leaf ``i`` (in schema
    order).  ``signature`` digests the full plan plus every group's plan,
    so two endpoints agreeing on it agree on the exact partition."""

    plan: RavelPlan
    groups: Tuple[Tuple[str, GroupPlan], ...]
    signature: str
    leaf_groups: Tuple[Tuple[str, ...], ...]

    @property
    def group_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.groups)

    def group(self, name: str) -> GroupPlan:
        for n, gp in self.groups:
            if n == name:
                return gp
        raise KeyError(f"schema has no group {name!r}")

    @property
    def full_coverage(self) -> bool:
        """Every leaf in exactly one group (the dense-equivalent case)."""
        return all(len(gs) == 1 for gs in self.leaf_groups)

    @property
    def covered(self) -> bool:
        """Every leaf in at least one group."""
        return all(len(gs) >= 1 for gs in self.leaf_groups)

    @property
    def disjoint(self) -> bool:
        """No leaf in more than one group."""
        return all(len(gs) <= 1 for gs in self.leaf_groups)


@dataclasses.dataclass
class AggStats:
    """Engine counters.  ``wire_bytes`` is what crossed the transport,
    ``folded_bytes`` the dense fp32 equivalent the reduce is worth; for
    the dense updates of this path the two are equal."""

    n_calls: int = 0
    last_wire_bytes: int = 0
    total_wire_bytes: int = 0
    last_folded_bytes: int = 0
    total_folded_bytes: int = 0

    def record(self, folded: int, wire: Optional[int] = None) -> None:
        """Account one update: dense-equivalent bytes, and wire bytes if
        they differ (``wire=None`` means the update arrived dense)."""
        w = folded if wire is None else wire
        self.last_wire_bytes = w
        self.total_wire_bytes += w
        self.last_folded_bytes = folded
        self.total_folded_bytes += folded

    @property
    def last_bytes(self) -> int:
        return self.last_folded_bytes

    @property
    def total_bytes(self) -> int:
        return self.total_folded_bytes


class AggregationEngine:
    """Flatten-once FedAvg reducer with cached per-model plans.

    The device is the clients' trees' own: CUDA tensors go through the
    ``fedavg_reduce`` kernel, CPU tensors through its plain version.

    Parameters
    ----------
    chunk_elems : if set, `reduce_flat` reduces column blocks of this
        many elements one after another.
    """

    def __init__(self, chunk_elems: Optional[int] = None) -> None:
        self.chunk_elems = chunk_elems
        self.stats = AggStats()

    @staticmethod
    def _normalized_weights(weights: Sequence[float]) -> np.ndarray:
        w = np.asarray(weights, np.float64)
        if w.ndim != 1 or w.size == 0:
            raise ValueError("weights must be a non-empty 1-D sequence")
        if w.sum() <= 0:
            raise ValueError("aggregation weights must sum to a positive value")
        return (w / w.sum()).astype(np.float32)

    # -- tree path (FLServer hot path) ---------------------------------------
    def aggregate(self, client_params: Sequence[Any], weights: Sequence[float]) -> Any:
        """Weighted average of N client trees: one flatten, one reduce.

        fp32 accumulation, cast back to each leaf's dtype; one pass over
        the client bytes per round."""
        w = self._normalized_weights(weights)
        if len(client_params) != w.size:
            raise ValueError("len(client_params) != len(weights)")
        self.stats.n_calls += 1
        nbytes = sum(
            leaf.numel() * leaf.element_size()
            for t in client_params for leaf in tree_flatten(t)[0]
        )
        self.stats.record(nbytes)
        plan = plan_for(client_params[0])
        stacked = plan.flatten_stack(list(client_params))
        red = self.reduce_flat(stacked, torch.from_numpy(w).to(stacked.device))
        return plan.unflatten(red)

    # -- flat path ((N, L) stacked buffers) ----------------------------------
    def reduce_flat(
        self,
        stacked: torch.Tensor,
        weights: Union[torch.Tensor, Sequence[float]],
        chunk_elems: Optional[int] = None,
    ) -> torch.Tensor:
        """Weighted average over axis 0 of an (N, L) buffer whose rows are
        each contiguous.  (The reference's ``donate`` has no counterpart:
        nothing here copies the buffer.)"""
        if stacked.dim() != 2:
            raise ValueError(f"expected (N, L) stacked buffer, got {tuple(stacked.shape)}")
        w = torch.as_tensor(weights, dtype=torch.float32, device=stacked.device)
        chunk = chunk_elems if chunk_elems is not None else self.chunk_elems
        if chunk:
            return self._reduce_flat_chunked(stacked, w, int(chunk))
        return fedavg_reduce(stacked, w)

    def _reduce_flat_chunked(self, stacked: torch.Tensor, w: torch.Tensor,
                             chunk: int) -> torch.Tensor:
        """Column-blocked reduce: each block through the same kernel."""
        L = stacked.shape[1]
        outs = [fedavg_reduce(stacked[:, off:off + chunk], w) for off in range(0, L, chunk)]
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    # -- streaming -----------------------------------------------------------
    def streaming(
        self,
        base: Any = None,
        base_round: Optional[int] = None,
        schema: Any = None,
    ) -> Union["StreamingAggregator", "StructuredStreamingAggregator"]:
        """New per-round streaming accumulator (async client folding).

        ``base`` switches the aggregator to flat/delta mode anchored on
        the round's global weights — required to fold
        :class:`~repro_torch.federated.compression.CompressedUpdate`
        payloads (deltas against ``base``) and the same weighted average
        for dense updates (the base cancels).  ``base_round`` tags the
        base so compressed updates carrying a ``base_round`` of their own
        are validated against it.

        ``schema`` (an :class:`UpdateSchema`, a resolved one, or a mapping
        of group name -> selector) switches to *structured* mode, a
        :class:`StructuredStreamingAggregator`; it needs ``base`` (absent
        groups keep the base's values)."""
        if schema is not None:
            if base is None:
                raise ValueError(
                    "streaming(schema=...) needs base=global_params: absent "
                    "groups and per-group deltas are defined relative to it"
                )
            return StructuredStreamingAggregator(self, schema, base, base_round=base_round)
        return StreamingAggregator(self, base=base, base_round=base_round)


def fused_stacked_tree_reduce(stacked: Any, weights: Any) -> Any:
    """FedAvg over a tree whose leaves carry a leading client (or pod
    replica) axis.

    Every leaf's rows go into one fp32 ``(N, L)`` buffer in the engine's
    padded layout (rows ``BLOCK``-aligned, as
    :meth:`RavelPlan.flatten_stack` lays them out) and one
    ``fedavg_reduce`` call reduces it: the kernel on a CUDA stack, its
    plain version on a CPU one.  ``weights`` (N,) need not be normalized.
    Each leaf comes back in its own dtype."""
    leaves, treedef = tree_flatten(stacked)
    if not leaves:
        return stacked
    n = leaves[0].shape[0]
    sizes = [int(np.prod(leaf.shape[1:])) for leaf in leaves]
    total = sum(sizes)
    buf = torch.empty((n, -(-total // BLOCK) * BLOCK), dtype=torch.float32,
                      device=leaves[0].device)
    off = 0
    for leaf, size in zip(leaves, sizes):
        buf[:, off:off + size].copy_(leaf.reshape(n, size))
        off += size
    red = fedavg_reduce(buf[:, :total],
                        torch.as_tensor(weights).to(buf.device, torch.float32))
    outs = []
    off = 0
    for leaf, size in zip(leaves, sizes):
        outs.append(red[off:off + size].reshape(leaf.shape[1:]).to(leaf.dtype))
        off += size
    return tree_unflatten(treedef, outs)


# ---------------------------------------------------------------------------
# Carry-over and staleness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CarryEntry:
    """One late ``c_msg_train`` buffered for a later round's average.

    The update was computed against ``origin_round``'s global weights; when
    it is finally folded, its example weight is discounted by the staleness
    factor ``discount ** (fold_round - origin_round)`` so fresh silos
    dominate while the straggler's contribution still lands (never silently
    dropped).

    ``params`` must be a *dense* tree: a compressed update encodes a delta
    against its origin round's base, which a later round no longer has —
    the async engine dequantizes at park time
    (:func:`~repro_torch.federated.compression.materialize_update`)."""

    client_id: str
    params: Any
    weight: float       # raw example weight (n_samples), undiscounted
    origin_round: int   # round whose deadline the message missed
    late_by_s: float = 0.0  # virtual seconds past that round's deadline
    # ||update - origin base||_2 at park time, when the engine had a base
    # to measure against (DriftAwareDiscount's input); None = not measured.
    origin_delta_norm: Optional[float] = None

    def age_at(self, round_idx: int) -> int:
        """Rounds of staleness when folded in ``round_idx`` (floor 1)."""
        return max(1, round_idx - self.origin_round)


class CarryOverBuffer:
    """Late updates parked between rounds (deadline-driven partial rounds).

    The async round engine defers any ``c_msg_train`` that misses its
    round's ``T_round`` deadline into this buffer; the next round's
    :class:`StreamingAggregator` drains it first (the messages are already
    on the server), folding each entry with a staleness-discounted weight.
    """

    def __init__(self) -> None:
        self._entries: List[CarryEntry] = []

    def defer(self, entry: CarryEntry) -> None:
        self._entries.append(entry)

    def drain(self) -> List[CarryEntry]:
        entries, self._entries = self._entries, []
        return entries

    def clients(self) -> List[str]:
        return [e.client_id for e in self._entries]

    def snapshot(self) -> List[CarryEntry]:
        """Non-destructive view of the parked entries (oldest first)."""
        return list(self._entries)

    def pending_weight(self) -> float:
        """Total raw (undiscounted) example weight awaiting a fold."""
        return sum(e.weight for e in self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)


class StalenessPolicy:
    """How much of a parked update's weight survives a late fold.

    ``effective_multiplier`` maps one :class:`CarryEntry` to the factor
    its raw example weight is scaled by when finally folded in
    ``round_idx``.  Policies advertising ``uses_drift`` also receive
    ``drift``: how far the global model moved since the update was parked,
    relative to the update's own step size."""

    uses_drift: ClassVar[bool] = False

    def effective_multiplier(
        self, entry: CarryEntry, round_idx: int, drift: Optional[float] = None
    ) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AgeDiscount(StalenessPolicy):
    """``discount ** age`` with age floored at 1 round (the same
    ``float(discount) ** int(age)`` expression as
    :meth:`StreamingAggregator.add_stale`)."""

    discount: float = 0.5

    def effective_multiplier(
        self, entry: CarryEntry, round_idx: int, drift: Optional[float] = None
    ) -> float:
        return float(self.discount) ** int(entry.age_at(round_idx))


@dataclasses.dataclass(frozen=True)
class DriftAwareDiscount(StalenessPolicy):
    """Convergence-aware staleness: the age discount, divided by
    ``1 + drift_coef * (drift - 1)`` when the model has drifted more than
    the parked update's own step (``drift > 1``); exactly
    :class:`AgeDiscount` when drift is small or unmeasured."""

    discount: float = 0.5
    drift_coef: float = 1.0

    uses_drift: ClassVar[bool] = True

    def effective_multiplier(
        self, entry: CarryEntry, round_idx: int, drift: Optional[float] = None
    ) -> float:
        base = float(self.discount) ** int(entry.age_at(round_idx))
        if drift is None or drift <= 1.0:
            return base
        return base / (1.0 + float(self.drift_coef) * (float(drift) - 1.0))


# ---------------------------------------------------------------------------
# Streaming / incremental accumulation
# ---------------------------------------------------------------------------

def _leaf_nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def _fold_compressed_into(acc: torch.Tensor, update: CompressedUpdate, w: float,
                          padded_len: int) -> torch.Tensor:
    """Fold one CompressedUpdate's delta into a padded fp32 accumulator, in
    place: int8 and fp16 payloads through ``dequant_fold`` (the kernel on
    a CUDA accumulator), top-k payloads with ``index_add_``.  The payload
    is moved to the accumulator's device if it is elsewhere (a frame
    decoded on the host)."""
    dev = acc.device
    if update.codec == "topk":
        if update.indices is None:
            raise ValueError("topk update has no indices")
        idx = update.indices.to(dev, torch.int64)
        vals = update.data.to(dev).to(torch.float32) * f32_scalar(w)
        # The reference's acc.at[idx].add outside any Pallas kernel.  The
        # indices are strictly increasing (the codec sorts them and
        # deserialize_update rejects any other frame), so no two threads
        # add to one element and the result is deterministic.
        return acc.index_add_(0, idx, vals)
    if update.codec in ("int8", "fp16"):
        nb = padded_len // QBLOCK
        if update.codec == "int8":
            if update.scales is None:
                raise ValueError("int8 update has no scales")
            scales = update.scales.to(dev, torch.float32)
            if tuple(scales.shape) != (nb,):
                raise ValueError(
                    f"int8 update has {tuple(scales.shape)} scales; expected ({nb},)"
                )
        else:
            scales = torch.ones(nb, dtype=torch.float32, device=dev)
        return dequant_fold(acc, update.data.to(dev), scales, w)
    raise ValueError(f"unknown compressed codec {update.codec!r}")


def _flat_partial_fold(acc: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``acc += other`` in place — fold a regional partial accumulator in
    (the reference's donated add outside any Pallas kernel)."""
    return acc.add_(other)


def _as_partial_acc(acc: Any, like: torch.Tensor) -> torch.Tensor:
    """A partial's accumulator as fp32 on ``like``'s device, converted
    explicitly when it lives elsewhere or in another dtype (the
    reference's ``jnp.asarray(acc, jnp.float32)``)."""
    return torch.as_tensor(acc).to(device=like.device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Partial sums (hierarchical aggregation)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartialSum:
    """One aggregator's exported partial fold — the hierarchy wire unit.

    ``acc`` is the BLOCK-padded fp32 delta accumulator (the exact buffer
    a flat-mode :class:`StreamingAggregator` holds: ``sum_i w_i *
    (update_i - base)``, zero-padded to the BLOCK multiple), so a parent
    folds it with one elementwise add and regional / parent results
    compose to the same weighted average the flat fold computes.
    ``wsum`` / ``n_clients`` are the region's raw weight total and client
    count; ``plan_signature`` pins the model structure and ``base_round``
    the global weights the deltas were taken against —
    :meth:`StreamingAggregator.fold_partial` validates both, because a
    partial folded against another structure or base is silent
    corruption."""

    acc: Any
    wsum: float
    n_clients: int
    plan_signature: str
    base_round: Optional[int] = None
    region_id: str = ""

    @property
    def wire_bytes(self) -> int:
        """Bytes a parent link carries for this partial (the fp32 acc)."""
        return _leaf_nbytes(self.acc)


@dataclasses.dataclass(frozen=True)
class StructuredPartialSum:
    """A structured aggregator's exported fold: one PartialSum per group.

    Groups no silo in the region contributed to are *omitted* — absent
    silos contribute no weight to a group, and that has to survive the
    hierarchy hop (a zero-accumulator partial with nonzero wsum would
    drag the group toward the base).  ``schema_signature`` pins the
    exact partition; each group's inner :class:`PartialSum` carries its
    own group-plan signature, and the parent validates both."""

    groups: Tuple[Tuple[str, PartialSum], ...]
    schema_signature: str
    n_clients: int
    base_round: Optional[int] = None
    region_id: str = ""

    @property
    def wire_bytes(self) -> int:
        """Bytes a parent link carries (sum of the per-group fp32 accs)."""
        return sum(p.wire_bytes for _, p in self.groups)

    @property
    def wsum(self) -> float:
        """Round-weight proxy for bus/event accounting: the largest
        per-group weight total (each group normalizes independently, so
        there is no single scalar — the max is what a fully-present silo
        cohort contributed)."""
        return max((p.wsum for _, p in self.groups), default=0.0)

    def group_wsums(self) -> Dict[str, float]:
        return {n: p.wsum for n, p in self.groups}


class StreamingAggregator:
    """Running weighted accumulation: fold clients in as they land.

    ``add(params, weight)`` costs one pass over that client's bytes and
    keeps only a single fp32 accumulator (updated in place), so
    asynchronously arriving silos are aggregated in O(L) memory rather
    than O(N·L).  ``result()`` normalizes by the running weight total,
    casts back to the model dtypes, and resets all per-fold state so a
    reused aggregator starts a fresh fold.

    With ``base`` (the round's global weights) the aggregator runs in
    *flat/delta mode*: one padded fp32 vector accumulator on the base's
    device, every update folded as ``w * (update - base)`` and the result
    read out as ``base + acc / wsum`` — the same weighted average (the
    base cancels), but able to fold
    :class:`~repro_torch.federated.compression.CompressedUpdate` payloads
    directly through the ``dequant_fold`` kernel, never materializing a
    dense fp32 update.

    The base survives ``result()`` so a flat-mode aggregator can be
    reused — but a reused aggregator folding the NEXT round's deltas must
    first :meth:`rebase` onto that round's global weights.  Construct with
    ``base_round`` to have :meth:`add_compressed` enforce the match
    against each update's own ``base_round`` tag.
    """

    def __init__(
        self,
        engine: Optional[AggregationEngine] = None,
        base: Any = None,
        base_round: Optional[int] = None,
    ) -> None:
        self._engine = engine
        self._plan: Optional[RavelPlan] = None
        self._base_flat: Optional[torch.Tensor] = None
        self._padded_len = 0
        self.base_round: Optional[int] = None
        if base is not None:
            self._plan = plan_for(base)
            self._base_flat = self._plan.flatten(base)
            self._padded_len = -(-self._plan.total_elems // BLOCK) * BLOCK
            self.base_round = base_round
        elif base_round is not None:
            raise ValueError("base_round tags a delta base: pass base= too")
        self._acc: Optional[List[torch.Tensor]] = None
        self._acc_flat: Optional[torch.Tensor] = None
        self._dtypes: Optional[List[torch.dtype]] = None
        self._treedef: Optional[TreeDef] = None
        self._shapes: Optional[Tuple[Tuple[int, ...], ...]] = None
        self._wsum = 0.0
        self.n_clients = 0

    def _reset(self) -> None:
        """Clear per-fold state (`result()` calls this); the base/plan are
        construction-time configuration and survive for reuse."""
        self._acc = None
        self._acc_flat = None
        self._dtypes = None
        self._treedef = None
        self._shapes = None
        self._wsum = 0.0
        self.n_clients = 0

    def _ensure_flat_acc(self) -> torch.Tensor:
        if self._acc_flat is None:
            assert self._base_flat is not None
            self._acc_flat = torch.zeros(self._padded_len, dtype=torch.float32,
                                         device=self._base_flat.device)
        return self._acc_flat

    def _sync(self) -> None:
        """Wait for the accumulator's device (``add(..., block=True)``)."""
        from .client import synchronize

        acc = self._acc_flat if self._acc_flat is not None else (self._acc or [None])[0]
        if isinstance(acc, torch.Tensor):
            synchronize(acc.device)

    @property
    def mid_fold(self) -> bool:
        """True while a fold is accumulating (clients added, no result yet)."""
        return self.n_clients > 0 or self._acc is not None or self._acc_flat is not None

    def rebase(self, base: Any, base_round: Optional[int] = None) -> None:
        """Re-anchor a reused flat-mode aggregator on a new round's base
        (same tree structure; rejected mid-fold, since the accumulator
        holds deltas against the old base)."""
        if self._plan is None or self._base_flat is None:
            raise ValueError(
                "rebase() applies to flat/delta mode: construct the "
                "aggregator with streaming(base=global_params) first"
            )
        if self.mid_fold:
            raise ValueError(
                "cannot rebase mid-fold: the accumulator holds deltas "
                "against the current base — call result() first"
            )
        plan = plan_for(base)
        if plan.signature != self._plan.signature:
            mismatch = _first_structure_mismatch(self._plan.treedef, self._plan.shapes, base)
            raise StructureMismatchError(
                "rebase() base does not match the aggregator's plan"
                + (f" at leaf {mismatch[0]!r}: {mismatch[1]}" if mismatch else ""),
                path=mismatch[0] if mismatch else None,
            )
        self._plan = plan
        self._base_flat = plan.flatten(base)
        self.base_round = base_round

    def _check_structure(self, params: Any, client_id: Optional[str]) -> None:
        if self._plan is not None:
            ref_treedef, ref_shapes = self._plan.treedef, self._plan.shapes
        elif self._treedef is not None and self._shapes is not None:
            ref_treedef, ref_shapes = self._treedef, self._shapes
        else:
            return
        mismatch = _first_structure_mismatch(ref_treedef, ref_shapes, params)
        if mismatch is not None:
            _raise_structure_mismatch(mismatch, client_id)

    def add(
        self,
        params: Any,
        weight: float,
        block: bool = False,
        wire_bytes: Optional[int] = None,
        client_id: Optional[str] = None,
    ) -> None:
        """Fold one client in; ``block=True`` waits for the device to finish
        the fold (the async round engine uses it to measure the true
        per-fold cost).  ``wire_bytes`` is the transport frame size when it
        differs from the dense bytes; compressed payloads route to
        :meth:`add_compressed`.  ``client_id`` names the silo in
        structure-mismatch errors."""
        if isinstance(params, CompressedUpdate):
            self.add_compressed(params, weight, block=block, wire_bytes=wire_bytes,
                                client_id=client_id)
            return
        w = float(weight)
        if w < 0:
            raise ValueError("client weight must be non-negative")
        self._check_structure(params, client_id)
        w32 = f32_scalar(w)
        if self._base_flat is not None:
            assert self._plan is not None
            acc = self._ensure_flat_acc()
            flat = self._plan.flatten(params).to(acc.device)
            acc[: self._plan.total_elems].add_((flat - self._base_flat) * w32)
        elif self._acc is None:
            leaves, self._treedef = tree_flatten(params)
            self._dtypes = [leaf.dtype for leaf in leaves]
            self._shapes = tuple(tuple(leaf.shape) for leaf in leaves)
            self._acc = [leaf.to(torch.float32) * w32 for leaf in leaves]
        else:
            for a, leaf in zip(self._acc, tree_flatten(params)[0]):
                a.add_(leaf.to(a.device, torch.float32) * w32)
        if block:
            self._sync()
        self._wsum += w
        self.n_clients += 1
        if self._engine is not None:
            nbytes = sum(_leaf_nbytes(leaf) for leaf in tree_flatten(params)[0])
            self._engine.stats.record(nbytes, wire_bytes)

    def add_compressed(
        self,
        update: CompressedUpdate,
        weight: float,
        block: bool = False,
        wire_bytes: Optional[int] = None,
        client_id: Optional[str] = None,
    ) -> None:
        """Fold one compressed delta straight into the fp32 accumulator.

        int8 / fp16 payloads go through ``dequant_fold`` — one pass over
        the quantized bytes, no dense fp32 intermediate; top-k payloads
        fold with a sparse ``index_add_``.  An update tagged with a
        ``base_round`` must match the aggregator's own tag: it is a delta
        against that round's global weights.  With the engine attached and
        no ``wire_bytes`` given, the wire size is counted by serializing
        the frame (``CompressedUpdate.wire_bytes``), as the reference does.
        """
        if self._base_flat is None or self._plan is None:
            raise ValueError(
                "compressed updates need a delta base: construct the "
                "aggregator with streaming(base=global_params)"
            )
        update_round = update.base_round
        if update_round is not None and update_round != self.base_round:
            who = f" from client {client_id!r}" if client_id is not None else ""
            raise ValueError(
                f"compressed update{who} was encoded against base round "
                f"{update_round}, but the aggregator's base is "
                f"{'untagged' if self.base_round is None else f'round {self.base_round}'}"
                " — rebase(new_base, base_round=...) the aggregator onto "
                "the update's round before folding"
            )
        if update.total_elems != self._plan.total_elems:
            raise ValueError(
                f"compressed update has {update.total_elems} elements; "
                f"the model has {self._plan.total_elems}"
            )
        w = float(weight)
        if w < 0:
            raise ValueError("client weight must be non-negative")
        acc = self._ensure_flat_acc()
        self._acc_flat = _fold_compressed_into(acc, update, w, self._padded_len)
        if block:
            self._sync()
        self._wsum += w
        self.n_clients += 1
        if self._engine is not None:
            wire = wire_bytes if wire_bytes is not None else update.wire_bytes
            self._engine.stats.record(update.dense_bytes, wire)

    def add_stale(
        self,
        params: Any,
        weight: float,
        stale_rounds: int,
        discount: float,
        block: bool = False,
        client_id: Optional[str] = None,
    ) -> float:
        """Fold a carried-over (stale) update with a staleness-discounted
        weight ``weight * discount**stale_rounds``; returns the effective
        weight that entered the average."""
        if stale_rounds < 1:
            raise ValueError("a stale fold must be at least one round late")
        if not 0.0 <= discount <= 1.0:
            raise ValueError("staleness discount must be in [0, 1]")
        w_eff = float(weight) * float(discount) ** int(stale_rounds)
        self.add(params, w_eff, block=block, client_id=client_id)
        return w_eff

    def fold_carry(
        self,
        buffer: CarryOverBuffer,
        round_idx: int,
        discount: float,
        block: bool = False,
    ) -> List[Tuple[CarryEntry, float]]:
        """Drain a :class:`CarryOverBuffer` into the accumulator, each entry
        at its staleness discount (age = ``round_idx - origin_round``, at
        least 1); returns the ``(entry, effective_weight)`` pairs."""
        folded: List[Tuple[CarryEntry, float]] = []
        for entry in buffer.drain():
            w_eff = self.add_stale(
                entry.params, entry.weight, entry.age_at(round_idx),
                discount, block=block, client_id=entry.client_id,
            )
            folded.append((entry, w_eff))
        return folded

    # -- hierarchy: partial-sum export / fold -------------------------------
    def export_partial(self, region_id: str = "") -> PartialSum:
        """Consume the fold as a :class:`PartialSum` instead of params.

        The regional half of the hierarchy: the padded accumulator,
        weight total, and client count leave as one composable unit (the
        base is NOT applied — the parent holds the same base and applies
        it once at finalize).  Flat/delta mode only: partial sums
        compose only against a shared base.  Like :meth:`result`, the
        per-fold state is consumed."""
        if self._plan is None or self._base_flat is None:
            raise ValueError(
                "export_partial() requires flat/delta mode: partial sums "
                "compose only against a shared base — construct the "
                "aggregator with streaming(base=global_params)"
            )
        if self.n_clients == 0:
            raise ValueError("no clients have been added")
        partial = PartialSum(
            acc=self._ensure_flat_acc(),
            wsum=self._wsum,
            n_clients=self.n_clients,
            plan_signature=self._plan.signature,
            base_round=self.base_round,
            region_id=region_id,
        )
        self._reset()
        if self._engine is not None:
            self._engine.stats.n_calls += 1
        return partial

    def fold_partial(self, partial: PartialSum, block: bool = False) -> None:
        """Fold a regional :class:`PartialSum` into this accumulator.

        One in-place elementwise add over the padded fp32 buffers —
        weighted partial sums compose associatively, so a parent folding
        R regional partials computes exactly the flat engine's
        ``sum_i w_i * (update_i - base)`` over all N clients.  The
        partial's plan signature and base-round tag must match this
        aggregator's (folding a partial taken against another structure
        or base is silent corruption)."""
        if self._plan is None or self._base_flat is None:
            raise ValueError(
                "fold_partial() requires flat/delta mode: construct the "
                "aggregator with streaming(base=global_params)"
            )
        if partial.n_clients < 1:
            raise ValueError("a partial sum must carry at least one client")
        if partial.wsum < 0:
            raise ValueError("partial weight total must be non-negative")
        if partial.plan_signature != self._plan.signature:
            raise StructureMismatchError(
                f"partial sum from region {partial.region_id!r} was taken "
                f"against plan {partial.plan_signature}, but this "
                f"aggregator's plan is {self._plan.signature}",
                client_id=partial.region_id or None,
            )
        if partial.base_round != self.base_round:
            raise ValueError(
                f"partial sum from region {partial.region_id!r} was "
                f"accumulated against base round {partial.base_round}, but "
                f"the aggregator's base is round {self.base_round}"
            )
        acc = self._ensure_flat_acc()
        other = _as_partial_acc(partial.acc, acc)
        if other.shape != acc.shape:
            raise ValueError(
                f"partial accumulator has shape {tuple(other.shape)}; the "
                f"parent's padded accumulator is {tuple(acc.shape)}"
            )
        self._acc_flat = _flat_partial_fold(acc, other)
        if block:
            self._sync()
        self._wsum += float(partial.wsum)
        self.n_clients += int(partial.n_clients)
        if self._engine is not None:
            nbytes = _leaf_nbytes(other)
            self._engine.stats.record(nbytes, nbytes)

    def result(self) -> Any:
        if self._acc is None and self._acc_flat is None:
            raise ValueError("no clients have been added")
        if self._wsum <= 0:
            raise ValueError("aggregation weights must sum to a positive value")
        inv = f32_scalar(1.0 / self._wsum)
        if self._acc_flat is not None:
            assert self._plan is not None and self._base_flat is not None
            L = self._plan.total_elems
            vec = self._base_flat + self._acc_flat[:L] * inv
            out = self._plan.unflatten(vec)
        else:
            assert self._acc is not None and self._dtypes is not None
            assert self._treedef is not None
            outs = [(a * inv).to(dt) for a, dt in zip(self._acc, self._dtypes)]
            out = tree_unflatten(self._treedef, outs)
        # Consume: every per-fold field goes with the accumulator — stale
        # normalizer state would silently double-count on reuse.
        self._reset()
        if self._engine is not None:
            self._engine.stats.n_calls += 1
        return out


# ---------------------------------------------------------------------------
# Structured (per-group) streaming folds
# ---------------------------------------------------------------------------

def _flat_group_scatter(num: torch.Tensor, start: int, vals: torch.Tensor) -> torch.Tensor:
    """``num += vals`` at one leaf's span of a group's compact accumulator:
    places the group's numerator.  Exact for a leaf one group covers,
    because ``num`` starts at -0.0 (``-0.0 + x == x`` for every x, the
    sign of a zero included)."""
    return num.add_(vals[start:start + num.numel()])


def _flat_finalize_vec(num: torch.Tensor, base: torch.Tensor, inv: float) -> torch.Tensor:
    """``base + num * inv`` — the dense finalize's arithmetic, per leaf."""
    return base + num * inv


def _ndim(v: Any) -> int:
    return v.dim() if isinstance(v, torch.Tensor) else int(np.ndim(v))


class StructuredStreamingAggregator:
    """Per-group streaming folds under an :class:`UpdateSchema`.

    Each named group keeps its own padded fp32 delta accumulator (on the
    base's device) and its own running weight total, so silos may ship
    any subset of the groups: a silo absent from a group contributes no
    weight to it, and each element of the result normalizes by the weight
    total of the groups that actually cover it (overlapping groups sum
    their totals).  Leaves no present group covers come back as the
    base's own tensors, untouched.

    ``add`` accepts, per client:

    * a :class:`~repro_torch.federated.compression.StructuredUpdate` (the
      wire form): per-group raw fp32 *values* or per-group compressed
      *deltas* against the aggregator's base;
    * a plain mapping ``{group name: payload}`` with the same per-group
      semantics (a 1-D vector is the group's raw values, a
      ``CompressedUpdate`` a delta);
    * a full model tree, structure-validated, then sliced into every group.

    A full-coverage schema (every leaf in exactly one group) with every
    client present in every group gives bit for bit the dense flat/delta
    fold's result: each group folds ``acc += (x - base) * w`` over its
    elements as the dense path does over all of them, the numerator is
    placed exactly, and each leaf is finalized as ``base + num * inv``
    with ``inv`` the same fp32 rounding of ``1 / wsum``.  Unlike the
    reference, the finalize works leaf by leaf and never builds a
    model-sized vector: at olmo-1b's width a fp32 copy of the model is 4.7
    GB, and an adapter round touches 0.04 % of it.
    """

    def __init__(self, engine: Optional[AggregationEngine],
                 schema: Union[UpdateSchema, ResolvedSchema, Mapping[str, Any]],
                 base: Any, base_round: Optional[int] = None) -> None:
        if base is None:
            raise ValueError(
                "structured aggregation needs the round's global weights: "
                "pass base= (per-group deltas and absent groups are both "
                "defined relative to it)"
            )
        self._engine = engine
        if isinstance(schema, ResolvedSchema):
            self._schema = schema
        else:
            resolved = as_update_schema(schema)
            assert resolved is not None
            self._schema = resolved.resolve(base)
        self._plan = self._schema.plan
        self._set_base(base)
        self.base_round = base_round
        self._accs: Dict[str, torch.Tensor] = {}
        self._wsums: Dict[str, float] = {n: 0.0 for n in self._schema.group_names}
        self._counts: Dict[str, int] = {n: 0 for n in self._schema.group_names}
        self.n_clients = 0

    def _set_base(self, base: Any) -> None:
        self._base_leaves = tree_flatten(base)[0]
        self._group_base = {name: gp.flatten(base) for name, gp in self._schema.groups}

    @property
    def schema(self) -> ResolvedSchema:
        return self._schema

    @property
    def mid_fold(self) -> bool:
        return self.n_clients > 0 or bool(self._accs)

    def group_wsums(self) -> Dict[str, float]:
        """Per-group running weight totals (weight-conservation audits)."""
        return dict(self._wsums)

    def group_counts(self) -> Dict[str, int]:
        """Per-group client counts (a silo counts once per group present)."""
        return dict(self._counts)

    def _reset(self) -> None:
        self._accs = {}
        self._wsums = {n: 0.0 for n in self._schema.group_names}
        self._counts = {n: 0 for n in self._schema.group_names}
        self.n_clients = 0

    def rebase(self, base: Any, base_round: Optional[int] = None) -> None:
        """Re-anchor on a new round's global weights (rejected mid-fold:
        the accumulators hold deltas against the current base)."""
        if self.mid_fold:
            raise ValueError(
                "cannot rebase mid-fold: the accumulators hold deltas "
                "against the current base — call result() first"
            )
        plan = plan_for(base)
        if plan.signature != self._plan.signature:
            mismatch = _first_structure_mismatch(self._plan.treedef, self._plan.shapes, base)
            raise StructureMismatchError(
                "rebase() base does not match the aggregator's plan"
                + (f" at leaf {mismatch[0]!r}: {mismatch[1]}" if mismatch else ""),
                path=mismatch[0] if mismatch else None,
            )
        self._set_base(base)
        self.base_round = base_round

    def _ensure_acc(self, name: str) -> torch.Tensor:
        acc = self._accs.get(name)
        if acc is None:
            acc = torch.zeros(self._schema.group(name).padded_len, dtype=torch.float32,
                              device=self._group_base[name].device)
            self._accs[name] = acc
        return acc

    def _check_base_round(self, update_round: Optional[int], client_id: Optional[str]) -> None:
        if update_round is not None and update_round != self.base_round:
            who = f" from client {client_id!r}" if client_id is not None else ""
            raise ValueError(
                f"structured update{who} was encoded against base round "
                f"{update_round}, but the aggregator's base is "
                f"{'untagged' if self.base_round is None else f'round {self.base_round}'}"
                " — rebase(new_base, base_round=...) the aggregator onto "
                "the update's round before folding"
            )

    def _payload_items(self, params: Any,
                       client_id: Optional[str]) -> Tuple[List[Tuple[str, Any]], Optional[int]]:
        """One client's payload as [(group, payload)], and its wire bytes."""
        from .compression import StructuredUpdate

        if isinstance(params, StructuredUpdate):
            if params.schema_signature != self._schema.signature:
                who = f" from client {client_id!r}" if client_id is not None else ""
                raise ValueError(
                    f"structured update{who} was encoded under schema "
                    f"{params.schema_signature}, but the aggregator's "
                    f"schema is {self._schema.signature}"
                )
            self._check_base_round(params.base_round, client_id)
            return list(params.groups), params.wire_bytes
        # A {group: payload} mapping only when its keys are all group names
        # and its values wire payloads; a model tree whose top level is a
        # dict of sub-trees falls through to the full-tree branch.
        if isinstance(params, Mapping) and params and all(
            k in self._wsums and not isinstance(v, Mapping)
            and (isinstance(v, CompressedUpdate) or _ndim(v) == 1)
            for k, v in params.items()
        ):
            return list(params.items()), None
        mismatch = _first_structure_mismatch(self._plan.treedef, self._plan.shapes, params)
        if mismatch is not None:
            _raise_structure_mismatch(mismatch, client_id)
        return [(name, gp.flatten(params)) for name, gp in self._schema.groups], None

    def add(self, params: Any, weight: float, block: bool = False,
            wire_bytes: Optional[int] = None, client_id: Optional[str] = None) -> None:
        """Fold one client's (possibly partial) structured update in.

        ``weight`` applies to every group the client shipped; groups the
        client omitted see neither the update nor the weight."""
        w = float(weight)
        if w < 0:
            raise ValueError("client weight must be non-negative")
        items, payload_wire = self._payload_items(params, client_id)
        if not items:
            raise ValueError("a structured update must carry at least one group")
        w32 = f32_scalar(w)
        folded_bytes = 0
        for name, payload in items:
            if name not in self._wsums:
                raise ValueError(
                    f"update carries unknown group {name!r}; the schema's "
                    f"groups are {list(self._schema.group_names)}"
                )
            gp = self._schema.group(name)
            acc = self._ensure_acc(name)
            if isinstance(payload, CompressedUpdate):
                self._check_base_round(payload.base_round, client_id)
                if payload.total_elems != gp.total_elems:
                    raise ValueError(
                        f"group {name!r} update has {payload.total_elems} "
                        f"elements; the group has {gp.total_elems}"
                    )
                self._accs[name] = _fold_compressed_into(acc, payload, w, gp.padded_len)
                folded_bytes += payload.dense_bytes
            else:
                vec = torch.as_tensor(payload).reshape(-1).to(acc.device, torch.float32)
                if vec.numel() != gp.total_elems:
                    raise ValueError(
                        f"group {name!r} payload has {vec.numel()} elements; "
                        f"the group has {gp.total_elems}"
                    )
                acc[: gp.total_elems].add_((vec - self._group_base[name]) * w32)
                folded_bytes += gp.total_elems * 4
            self._wsums[name] += w
            self._counts[name] += 1
        if block:
            from .client import synchronize

            synchronize(next(iter(self._accs.values())).device)
        self.n_clients += 1
        if self._engine is not None:
            self._engine.stats.record(folded_bytes,
                                      wire_bytes if wire_bytes is not None else payload_wire)

    def add_stale(self, params: Any, weight: float, stale_rounds: int, discount: float,
                  block: bool = False, client_id: Optional[str] = None) -> float:
        """Staleness-discounted structured fold (the dense rule)."""
        if stale_rounds < 1:
            raise ValueError("a stale fold must be at least one round late")
        if not 0.0 <= discount <= 1.0:
            raise ValueError("staleness discount must be in [0, 1]")
        w_eff = float(weight) * float(discount) ** int(stale_rounds)
        self.add(params, w_eff, block=block, client_id=client_id)
        return w_eff

    def fold_carry(self, buffer: CarryOverBuffer, round_idx: int, discount: float,
                   block: bool = False) -> List[Tuple[CarryEntry, float]]:
        """Drain parked entries with the age discount (dense parity)."""
        folded: List[Tuple[CarryEntry, float]] = []
        for entry in buffer.drain():
            w_eff = self.add_stale(entry.params, entry.weight, entry.age_at(round_idx),
                                   discount, block=block, client_id=entry.client_id)
            folded.append((entry, w_eff))
        return folded

    # -- hierarchy: per-group partial export / fold --------------------------
    def export_partial(self, region_id: str = "") -> StructuredPartialSum:
        """Consume the fold as one :class:`PartialSum` per present group.

        Groups no client contributed to are omitted entirely — absent
        silos contribute no weight, and the parent must see that."""
        if self.n_clients == 0:
            raise ValueError("no clients have been added")
        groups: List[Tuple[str, PartialSum]] = []
        for name, gp in self._schema.groups:
            if self._counts[name] == 0:
                continue
            groups.append((name, PartialSum(
                acc=self._ensure_acc(name),
                wsum=self._wsums[name],
                n_clients=self._counts[name],
                plan_signature=gp.signature,
                base_round=self.base_round,
                region_id=region_id,
            )))
        partial = StructuredPartialSum(
            groups=tuple(groups),
            schema_signature=self._schema.signature,
            n_clients=self.n_clients,
            base_round=self.base_round,
            region_id=region_id,
        )
        self._reset()
        if self._engine is not None:
            self._engine.stats.n_calls += 1
        return partial

    def fold_partial(self, partial: StructuredPartialSum, block: bool = False) -> None:
        """Fold a regional :class:`StructuredPartialSum` in, per group."""
        if partial.schema_signature != self._schema.signature:
            raise StructureMismatchError(
                f"structured partial from region {partial.region_id!r} was "
                f"taken under schema {partial.schema_signature}, but this "
                f"aggregator's schema is {self._schema.signature}",
                client_id=partial.region_id or None,
            )
        if partial.base_round != self.base_round:
            raise ValueError(
                f"structured partial from region {partial.region_id!r} was "
                f"accumulated against base round {partial.base_round}, but "
                f"the aggregator's base is round {self.base_round}"
            )
        if partial.n_clients < 1:
            raise ValueError("a partial sum must carry at least one client")
        last: Optional[torch.Tensor] = None
        total_bytes = 0
        for name, p in partial.groups:
            if name not in self._wsums:
                raise ValueError(
                    f"structured partial carries unknown group {name!r}"
                )
            gp = self._schema.group(name)
            if p.plan_signature != gp.signature:
                raise StructureMismatchError(
                    f"group {name!r} partial was taken against plan "
                    f"{p.plan_signature}, but this aggregator's group plan "
                    f"is {gp.signature}",
                    client_id=partial.region_id or None,
                )
            if p.wsum < 0:
                raise ValueError("partial weight total must be non-negative")
            acc = self._ensure_acc(name)
            other = _as_partial_acc(p.acc, acc)
            if other.shape != acc.shape:
                raise ValueError(
                    f"group {name!r} partial accumulator has shape "
                    f"{tuple(other.shape)}; the parent's is {tuple(acc.shape)}"
                )
            self._accs[name] = last = _flat_partial_fold(acc, other)
            self._wsums[name] += float(p.wsum)
            self._counts[name] += int(p.n_clients)
            total_bytes += _leaf_nbytes(other)
        if block and last is not None:
            from .client import synchronize

            synchronize(last.device)
        self.n_clients += int(partial.n_clients)
        if self._engine is not None:
            self._engine.stats.record(total_bytes, total_bytes)

    def result(self) -> Any:
        """Finalize, leaf by leaf: each covered leaf's numerator is the sum
        of its covering groups' accumulators (schema order), normalized by
        the sum of their weight totals (Python floats, as the dense path
        sums them); ``base + numerator * inv`` in the leaf's dtype.  A leaf
        no present group covers is the base's tensor itself."""
        if self.n_clients == 0:
            raise ValueError("no clients have been added")
        if not any(w > 0 for w in self._wsums.values()):
            raise ValueError("aggregation weights must sum to a positive value")
        present = {n: w for n, w in self._wsums.items() if self._counts[n] > 0}
        spans: Dict[int, List[Tuple[str, int]]] = {}
        for name, gp in self._schema.groups:
            if name in present:
                for i, start in zip(gp.leaf_indices, gp.starts):
                    spans.setdefault(i, []).append((name, start))
        out = []
        for i, (leaf, dtype) in enumerate(zip(self._base_leaves, self._plan.dtypes)):
            wsum_leaf = 0.0
            for name in self._schema.leaf_groups[i]:
                if name in present:
                    wsum_leaf += present[name]
            if wsum_leaf <= 0:
                out.append(leaf)
                continue
            base = leaf.reshape(-1).float()
            num = torch.full_like(base, -0.0)
            for name, start in spans[i]:
                _flat_group_scatter(num, start, self._accs[name])
            vec = _flat_finalize_vec(num, base, f32_scalar(1.0 / wsum_leaf))
            out.append(vec.reshape(leaf.shape).to(dtype))
        self._reset()
        if self._engine is not None:
            self._engine.stats.n_calls += 1
        return tree_unflatten(self._plan.treedef, out)


# ---------------------------------------------------------------------------
# Cost-accounting hook (simulator integration)
# ---------------------------------------------------------------------------

def make_measured_aggreg_fn(
    env: Any,
    bytes_per_round: int,
    gb_per_s: float,
    base_vm_id: Optional[str] = None,
) -> Callable[[str], float]:
    """Build a `CostModel.t_aggreg` override from a measured reduce rate.

    ``bytes_per_round`` is the dense-equivalent byte volume the server
    reduces each round (N clients x model bytes, e.g.
    `AggStats.last_folded_bytes` — the reduce runs over dequantized fp32
    regardless of what crossed the wire, so folded, not wire, bytes set
    the aggregation time);
    ``gb_per_s`` the measured engine bandwidth (the fold span a server
    measured on its device).  The time scales with each VM's instance
    slowdown exactly like the paper's `aggreg_bl` baseline does.
    """
    if gb_per_s <= 0:
        raise ValueError("gb_per_s must be positive")
    base_s = bytes_per_round / (gb_per_s * 1e9)
    base_slow = env.inst_slowdown(base_vm_id) if base_vm_id is not None else 1.0

    def t_aggreg(vm_id: str) -> float:
        return base_s * env.inst_slowdown(vm_id) / base_slow

    return t_aggreg
