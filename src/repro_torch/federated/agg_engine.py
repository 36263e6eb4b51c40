"""Fused FedAvg aggregation engine — the server's per-round hot path.

The port of the dense part of ``repro/federated/agg_engine.py``.  At
cross-silo model sizes the FedAvg reduce is a pure memory-bound stream,
so the engine's job is to touch every client byte once per round:

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
every odd row.)

A chunked mode (``reduce_flat(..., chunk_elems=...)``) reduces column
blocks one at a time.  The streaming, structured and compressed folds,
carry-over and partial sums of the reference come with later slices.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.fedavg_reduce import BLOCK, fedavg_reduce
from ..utils.tree import TreeDef, path_str, tree_flatten, tree_flatten_with_path, tree_unflatten


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
        pairs, treedef = tree_flatten_with_path(tree)
        if treedef != self.treedef:
            raise StructureMismatchError(
                f"update {index} has structure {treedef}, expected {self.treedef}",
                path="<root>",
            )
        for (path, leaf), shape in zip(pairs, self.shapes):
            if tuple(leaf.shape) != shape:
                where = path_str(path)
                raise StructureMismatchError(
                    f"update {index} leaf {where!r} has shape "
                    f"{tuple(leaf.shape)}, expected {shape}",
                    path=where,
                )
        return [leaf for _, leaf in pairs]

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


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AggStats:
    """Engine counters.  ``n_traces`` counts XLA retraces in the
    reference; the port runs eagerly and traces or compiles nothing per
    call, so it stays 0 (kept so a caller that checks for retraces reads
    the same field).  ``wire_bytes`` is what crossed the transport,
    ``folded_bytes`` the dense fp32 equivalent the reduce is worth; for
    the dense updates of this path the two are equal."""

    n_calls: int = 0
    n_traces: int = 0
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
