"""Two-level aggregation hierarchy: regional cohort folds that compose.

The port of ``repro/federated/hierarchy.py``.  The paper's cross-silo
deployment tops out at a handful of silos per cloud; the scaling shape
comes from the aggregator-per-facility topology of "Scalable
Cross-Facility Federated Learning" (PAPERS.md): a tree of streaming
aggregators whose *weighted partial sums compose associatively*.  A
flat-mode :class:`~repro_torch.federated.agg_engine.StreamingAggregator`
already holds exactly that representation — ``acc = sum_i w_i *
(update_i - base)`` plus the raw weight total — so a hierarchy is an
orchestration layer, not new math:

  clients ──► :class:`RegionalAggregator` (one per region; each runs the
  existing :class:`~repro_torch.federated.async_server.AsyncRoundEngine`
  over its cohort with the full deadline / carry-over / §4.3 re-request
  machinery, int8 and fp16 updates folded by ``dequant_fold``) ──►
  :class:`~repro_torch.federated.agg_engine.PartialSum` (padded fp32
  accumulator + weight total + client count + plan signature) ──► parent
  :meth:`~repro_torch.federated.agg_engine.StreamingAggregator.fold_partial`
  ──► finalized round params.

Because addition of the weighted deltas is what both levels compute, the
hierarchical result is *numerically identical* to the flat single-engine
fold over the same clients on inputs whose sums never round
(``tests/test_torch_hierarchy.py``, exact-arithmetic inputs).

Three scale levers ride along:

- **Cohort sampling** (:class:`CohortSampler`): serve a large population
  by folding a seeded per-round cohort (numpy's ``default_rng((seed,
  round))``, so both packages pick the same silos).
- **Sharded parent folds** (:class:`ShardedPartialFolder`): the regional
  accumulators are stacked ``(R, L_pad)``, each rank of a
  ``torch.distributed`` group (a 1-D "pod" mesh) sums its block of rows,
  and an all-reduce adds the blocks; a process with no group is a pod of
  one and sums alone.
- **O(regions) parent work**: the parent folds R partials, not N
  clients, so the root's per-round cost is independent of cohort size.

The control-plane face is :class:`HierarchyCoordinator` (the concrete
``HierarchyAPI`` — see :mod:`repro_torch.core.control_plane`), which
publishes typed :class:`~repro_torch.core.events.RegionClosed` /
:class:`~repro_torch.core.events.PartialFolded` events on the parent
bus.  :class:`HierarchicalFLServer` drives real clients through it.
Every level follows the device of the round's params: the card unless
the caller put them on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.events import NULL_BUS, EventBus, PartialFolded, RegionClosed
from .agg_engine import (
    AggregationEngine,
    CarryEntry,
    PartialSum,
    StructuredPartialSum,
    as_update_schema,
)
from .async_server import (
    ArrivalSchedule,
    AsyncFLServer,
    AsyncRoundEngine,
    FoldReport,
    InstantSchedule,
    RoundDeadline,
)
from .client import ClientResult, synchronize, tree_device

__all__ = [
    "CohortSampler",
    "HierarchicalFLServer",
    "HierarchyCoordinator",
    "HierarchyFoldReport",
    "RegionalAggregator",
    "ShardedPartialFolder",
    "as_cohort_sampler",
    "partition_regions",
]


# ---------------------------------------------------------------------------
# Cohort sampling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CohortSampler:
    """Seeded per-round cohort selection over a client population.

    Exactly one of ``fraction`` (in ``(0, 1]``) or ``size`` (>= 1) picks
    the cohort; sampling is uniform without replacement, deterministic
    per ``(seed, round_idx)`` (the rng is re-derived every round, so
    replays and sim/live parity hold regardless of call order), and the
    returned cohort preserves the population's order."""

    fraction: Optional[float] = None
    size: Optional[int] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if (self.fraction is None) == (self.size is None):
            raise ValueError(
                "specify exactly one of fraction= or size= for the cohort"
            )
        if self.fraction is not None and not (0.0 < self.fraction <= 1.0):
            raise ValueError(
                f"cohort fraction must be in (0, 1], got {self.fraction}"
            )
        if self.size is not None and self.size < 1:
            raise ValueError(f"cohort size must be >= 1, got {self.size}")

    def cohort_size(self, population: int) -> int:
        """Number of clients a round folds (at least 1, at most all)."""
        if population < 1:
            raise ValueError("cannot sample from an empty population")
        if self.size is not None:
            return min(self.size, population)
        assert self.fraction is not None
        return max(1, min(population, int(round(population * self.fraction))))

    def sample(self, round_idx: int, client_ids: Sequence[str]) -> List[str]:
        """The round's cohort, in stable population order."""
        ids = list(client_ids)
        k = self.cohort_size(len(ids))
        if k >= len(ids):
            return ids
        rng = np.random.default_rng((self.seed, round_idx))
        idx = np.sort(rng.choice(len(ids), size=k, replace=False))
        return [ids[int(i)] for i in idx]


def as_cohort_sampler(
    cohort: Union[None, float, int, CohortSampler], seed: int = 0
) -> Optional[CohortSampler]:
    """Coerce the user-facing cohort knob: None (fold everyone), a float
    fraction, an int fixed size, or a ready :class:`CohortSampler`."""
    if cohort is None or isinstance(cohort, CohortSampler):
        return cohort
    if isinstance(cohort, bool):
        raise ValueError("cohort must be a fraction, a size, or a CohortSampler")
    if isinstance(cohort, int):
        return CohortSampler(size=cohort, seed=seed)
    if isinstance(cohort, float):
        return CohortSampler(fraction=cohort, seed=seed)
    raise ValueError(
        f"cohort must be None, a float fraction, an int size, or a "
        f"CohortSampler; got {type(cohort).__name__}"
    )


# ---------------------------------------------------------------------------
# Region partitioning
# ---------------------------------------------------------------------------

def partition_regions(
    client_ids: Sequence[str],
    regions: Union[int, Mapping[str, Sequence[str]]],
) -> Dict[str, List[str]]:
    """Client -> region assignment, validated.

    ``regions`` is either an int (round-robin into ``region0..regionR-1``
    — a stand-in for real geography) or an explicit mapping of region id
    to client ids.  Every client must land in exactly one region and
    every region must be non-empty."""
    ids = [str(c) for c in client_ids]
    if isinstance(regions, int):
        if regions < 1:
            raise ValueError(f"need at least one region, got {regions}")
        if regions > len(ids):
            raise ValueError(
                f"{regions} regions for {len(ids)} clients: every region "
                "needs at least one client"
            )
        out: Dict[str, List[str]] = {f"region{i}": [] for i in range(regions)}
        for i, cid in enumerate(ids):
            out[f"region{i % regions}"].append(cid)
        return out
    seen: Dict[str, str] = {}
    mapped: Dict[str, List[str]] = {}
    for rid, cids in regions.items():
        rcids = [str(c) for c in cids]
        if not rcids:
            raise ValueError(f"region {rid!r} has no clients")
        for cid in rcids:
            if cid in seen:
                raise ValueError(
                    f"client {cid!r} appears in regions {seen[cid]!r} "
                    f"and {rid!r}"
                )
            seen[cid] = str(rid)
        mapped[str(rid)] = rcids
    if not mapped:
        raise ValueError("region mapping is empty")
    return mapped


# ---------------------------------------------------------------------------
# Regional aggregator
# ---------------------------------------------------------------------------

class RegionalAggregator:
    """One region's cohort folds, exported as composable partial sums.

    Wraps its own :class:`~repro_torch.federated.async_server.AsyncRoundEngine`
    — the region keeps private per-region state (carry-over buffer,
    straggler streaks, re-request budget), so deadline-driven partial
    rounds and §4.3 revocation recovery behave exactly as they do on a
    flat server, just scoped to the region's clients.  The engine's own
    bus defaults to :data:`~repro_torch.core.events.NULL_BUS` (a 16-region
    x 10k-client round would otherwise record every per-fold event); the
    parent-level :class:`~repro_torch.core.events.RegionClosed` /
    :class:`~repro_torch.core.events.PartialFolded` summaries are
    published by the coordinator."""

    def __init__(
        self,
        region_id: str,
        client_ids: Sequence[str],
        engine: AsyncRoundEngine,
    ) -> None:
        self.region_id = str(region_id)
        self.client_ids = [str(c) for c in client_ids]
        self.engine = engine

    def fold_region(
        self,
        round_idx: int,
        results: Sequence[ClientResult],
        schedule: ArrivalSchedule,
        base_params: Any,
        deadline: Optional[RoundDeadline] = None,
    ) -> FoldReport:
        """Run the region's round; the report carries a
        :class:`~repro_torch.federated.agg_engine.PartialSum` (tagged with
        this region's id) instead of finalized params."""
        report = self.engine.fold_round(
            round_idx, results, schedule, deadline=deadline,
            base_params=base_params, emit_partial=True,
        )
        assert report.partial is not None
        report.partial = dataclasses.replace(
            report.partial, region_id=self.region_id
        )
        return report


# ---------------------------------------------------------------------------
# Sharded parent folds (a "pod" process group + all-reduce)
# ---------------------------------------------------------------------------

# The collective backend each accumulator device needs.
_BACKEND_FOR_DEVICE = {"cuda": "nccl", "cpu": "gloo"}


def _require_backend(backend: str, device: torch.device) -> None:
    """Raise unless ``backend`` (a group's backend string, possibly the
    ``"cpu:gloo,cuda:nccl"`` form) reduces tensors on ``device`` natively:
    NCCL for CUDA tensors, gloo for CPU ones.  Nothing is copied through
    the host to make another pairing work."""
    want = _BACKEND_FOR_DEVICE.get(device.type)
    if ":" in backend:
        table = dict(part.split(":", 1) for part in backend.split(","))
        have = table.get(device.type)
    else:
        have = backend
    if want is None or have != want:
        raise ValueError(
            f"a {backend!r} process group cannot all-reduce {device.type} "
            f"accumulators: {device.type} tensors need "
            f"{want or 'a cuda or cpu device'}"
        )


class ShardedPartialFolder:
    """Reduce regional accumulators across the ranks of a pod.

    The R regional ``(L_pad,)`` fp32 accumulators are stacked into an
    ``(R, L_pad)`` buffer on their device, its rows padded with zeros to a
    multiple of the pod size (zero rows are exact no-ops for a sum); each
    rank sums its own block of rows and an all-reduce (SUM) over the
    pod's group produces the replicated total — the reference's
    ``shard_map`` + ``psum`` over the "pod" mesh axis.

    ``mesh`` is None or a 1-D ``torch.distributed.device_mesh.DeviceMesh``
    whose dimension is named ``"pod"``.  With no mesh the folder uses the
    default process group when one is initialized, and is otherwise a pod
    of one process that sums alone and runs no collective (the
    reference's one-device mesh).  The group's backend must match the
    accumulators' device: NCCL for CUDA tensors, gloo for CPU ones.
    ``n_collectives`` counts the all-reduces run."""

    def __init__(self, mesh: Optional[Any] = None) -> None:
        self.mesh = mesh
        self._group: Optional[Any] = None  # None: a pod of one, no collective
        if mesh is not None:
            if mesh.ndim != 1 or tuple(mesh.mesh_dim_names or ()) != ("pod",):
                raise ValueError(
                    f"ShardedPartialFolder needs a 1-D mesh named ('pod',), got "
                    f"dimensions {mesh.mesh_dim_names} of shape {tuple(mesh.shape)}"
                )
            self._group = mesh.get_group("pod")
            self.pod_size = int(mesh.size())
        elif dist.is_available() and dist.is_initialized():
            self._group = dist.group.WORLD
            self.pod_size = int(dist.get_world_size())
        else:
            self.pod_size = 1
        self.n_collectives = 0

    def reduce(self, accs: Sequence[Any]) -> torch.Tensor:
        """Sum R accumulators into one ``(L_pad,)`` fp32 vector."""
        if not accs:
            raise ValueError("nothing to reduce")
        first = torch.as_tensor(accs[0])
        rows = torch.stack([
            torch.as_tensor(a).to(device=first.device, dtype=torch.float32)
            for a in accs
        ])
        pad = (-rows.shape[0]) % self.pod_size
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
        if self._group is None:
            return torch.sum(rows, dim=0)
        _require_backend(str(dist.get_backend(self._group)), rows.device)
        per_rank = rows.shape[0] // self.pod_size
        start = dist.get_rank(self._group) * per_rank
        out = torch.sum(rows[start:start + per_rank], dim=0)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self._group)
        self.n_collectives += 1
        return out


# ---------------------------------------------------------------------------
# Coordinator (the concrete HierarchyAPI)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HierarchyFoldReport(FoldReport):
    """A :class:`~repro_torch.federated.async_server.FoldReport` over the
    whole tree, plus per-region detail.

    The inherited fields summarize the round: ``params`` is the parent's
    finalized average, ``events``/``fold_times`` concatenate every
    region's folds, ``round_span_s`` is the slowest region's span (the
    regions run concurrently) plus the parent fold, and
    ``busy_s``/``carried_over``/``carried_in``/``escalations`` aggregate
    across regions."""

    region_reports: Dict[str, FoldReport] = dataclasses.field(
        default_factory=dict
    )
    partials: List[PartialSum] = dataclasses.field(default_factory=list)
    parent_fold_s: float = 0.0


class HierarchyCoordinator:
    """Orchestrates regional engines and the parent partial-sum fold.

    The concrete ``HierarchyAPI`` implementation
    (:mod:`repro_torch.core.control_plane`): owns one
    :class:`RegionalAggregator` per region (each with a private
    :class:`~repro_torch.federated.async_server.AsyncRoundEngine` sharing a
    single :class:`~repro_torch.federated.agg_engine.AggregationEngine`),
    the optional :class:`CohortSampler`, and the parent fold — sequential
    :meth:`~repro_torch.federated.agg_engine.StreamingAggregator.fold_partial`
    calls, or a :class:`ShardedPartialFolder` all-reduce when
    ``sharded=True``.  Publishes :class:`~repro_torch.core.events.RegionClosed`
    and :class:`~repro_torch.core.events.PartialFolded` on ``bus``.
    """

    def __init__(
        self,
        region_map: Mapping[str, Sequence[str]],
        agg_engine: Optional[AggregationEngine] = None,
        sampler: Optional[CohortSampler] = None,
        deadline: Optional[RoundDeadline] = None,
        carry_discount: float = 0.5,
        escalate_after: int = 2,
        on_revocation: str = "rerequest",
        recovery_delay_s: float = 0.0,
        max_rerequests: int = 1,
        fold_cost_s: Optional[float] = None,
        sharded: bool = False,
        mesh: Optional[Any] = None,
        bus: Optional[EventBus] = None,
        schema: Optional[Any] = None,
        staleness_policy: Optional[Any] = None,
    ) -> None:
        if not region_map:
            raise ValueError("a hierarchy needs at least one region")
        self.agg_engine = agg_engine if agg_engine is not None else AggregationEngine()
        # Structured updates: every regional engine folds the schema's
        # named groups and exports a StructuredPartialSum; the parent
        # folds those per group under the same schema.
        self.schema = as_update_schema(schema)
        self.sampler = sampler
        self.bus = bus if bus is not None else EventBus()
        self.sharded = sharded
        self._folder = ShardedPartialFolder(mesh) if sharded else None
        self._regions: Dict[str, RegionalAggregator] = {}
        self._region_of: Dict[str, str] = {}
        for rid, cids in region_map.items():
            if not cids:
                raise ValueError(f"region {rid!r} has no clients")
            engine = AsyncRoundEngine(
                self.agg_engine,
                on_revocation=on_revocation,
                recovery_delay_s=recovery_delay_s,
                max_rerequests=max_rerequests,
                fold_cost_s=fold_cost_s,
                deadline=deadline,
                carry_discount=carry_discount,
                escalate_after=escalate_after,
                bus=NULL_BUS,
                schema=self.schema,
                staleness_policy=staleness_policy,
            )
            region = RegionalAggregator(str(rid), cids, engine)
            self._regions[region.region_id] = region
            for cid in region.client_ids:
                if cid in self._region_of:
                    raise ValueError(
                        f"client {cid!r} appears in regions "
                        f"{self._region_of[cid]!r} and {region.region_id!r}"
                    )
                self._region_of[cid] = region.region_id

    @property
    def folder(self) -> Optional[ShardedPartialFolder]:
        """The sharded parent's folder (None for the sequential parent)."""
        return self._folder

    # -- HierarchyAPI ------------------------------------------------------
    @property
    def region_ids(self) -> List[str]:
        return list(self._regions)

    def region(self, region_id: str) -> RegionalAggregator:
        return self._regions[str(region_id)]

    def region_of(self, client_id: str) -> str:
        """The region a client folds through (KeyError if unmapped)."""
        return self._region_of[str(client_id)]

    def cohort_for(
        self, round_idx: int, client_ids: Sequence[str]
    ) -> List[str]:
        """The round's cohort (the whole population without a sampler)."""
        ids = [str(c) for c in client_ids]
        if self.sampler is None:
            return ids
        return self.sampler.sample(round_idx, ids)

    def pending_carryover(self) -> List[Tuple[str, CarryEntry]]:
        """Every region's parked late updates, as (region_id, entry)."""
        out: List[Tuple[str, CarryEntry]] = []
        for rid, region in self._regions.items():
            out.extend((rid, e) for e in region.engine.carry.snapshot())
        return out

    def fold_partials(
        self,
        round_idx: int,
        partials: Sequence[PartialSum],
        base_params: Any,
        now_s: float = 0.0,
    ) -> Any:
        """Fold regional partial sums into the round's finalized params.

        Sequential in-place adds, or — ``sharded=True`` — one stacked
        all-reduce over the pod.  Either way the result is ``base +
        (sum_r acc_r) / (sum_r wsum_r)``: the flat fold's weighted average
        over every client in every partial."""
        ps = list(partials)
        if not ps:
            raise ValueError("no partial sums to fold")
        agg = self.agg_engine.streaming(
            base=base_params, base_round=round_idx, schema=self.schema
        )
        if self._folder is not None and len(ps) > 1:
            if self.schema is not None:
                combined: Any = self._combine_structured_sharded(ps)
            else:
                head = ps[0]
                for p in ps[1:]:
                    if p.plan_signature != head.plan_signature:
                        raise ValueError(
                            f"partial sums disagree on the model structure: "
                            f"region {p.region_id!r} vs {head.region_id!r}"
                        )
                    if p.base_round != head.base_round:
                        raise ValueError(
                            f"partial sums disagree on the base round: region "
                            f"{p.region_id!r} has {p.base_round}, region "
                            f"{head.region_id!r} has {head.base_round}"
                        )
                combined = PartialSum(
                    acc=self._folder.reduce([p.acc for p in ps]),
                    wsum=sum(p.wsum for p in ps),
                    n_clients=sum(p.n_clients for p in ps),
                    plan_signature=head.plan_signature,
                    base_round=head.base_round,
                    region_id="<sharded>",
                )
            agg.fold_partial(combined, block=True)
        else:
            for p in ps:
                agg.fold_partial(p, block=True)
        for p in ps:
            self.bus.publish(
                PartialFolded(now_s, round_idx, p.region_id,
                              p.n_clients, p.wsum, base_round=p.base_round)
            )
        return agg.result()

    def _combine_structured_sharded(
        self, ps: Sequence[StructuredPartialSum]
    ) -> StructuredPartialSum:
        """Group-wise all-reduce of structured regional partials.

        Each group's accumulators are stacked and reduced over the pod
        independently (regions omitting a group contribute nothing to
        it); the combined partial carries the union of groups with
        per-group weight/count totals."""
        assert self._folder is not None
        head = ps[0]
        for p in ps[1:]:
            if p.schema_signature != head.schema_signature:
                raise ValueError(
                    f"structured partials disagree on the schema: region "
                    f"{p.region_id!r} vs {head.region_id!r}"
                )
            if p.base_round != head.base_round:
                raise ValueError(
                    f"structured partials disagree on the base round: "
                    f"region {p.region_id!r} has {p.base_round}, region "
                    f"{head.region_id!r} has {head.base_round}"
                )
        by_group: Dict[str, List[PartialSum]] = {}
        order: List[str] = []
        for p in ps:
            for name, gpart in p.groups:
                if name not in by_group:
                    by_group[name] = []
                    order.append(name)
                by_group[name].append(gpart)
        groups: List[Tuple[str, PartialSum]] = []
        for name in order:
            parts = by_group[name]
            sig = parts[0].plan_signature
            for gp in parts[1:]:
                if gp.plan_signature != sig:
                    raise ValueError(
                        f"group {name!r} partials disagree on the group "
                        f"plan signature"
                    )
            groups.append((name, PartialSum(
                acc=self._folder.reduce([gp.acc for gp in parts]),
                wsum=sum(gp.wsum for gp in parts),
                n_clients=sum(gp.n_clients for gp in parts),
                plan_signature=sig,
                base_round=head.base_round,
                region_id="<sharded>",
            )))
        return StructuredPartialSum(
            groups=tuple(groups),
            schema_signature=head.schema_signature,
            n_clients=sum(p.n_clients for p in ps),
            base_round=head.base_round,
            region_id="<sharded>",
        )

    def fold_round(
        self,
        round_idx: int,
        results: Sequence[ClientResult],
        schedule: Optional[ArrivalSchedule] = None,
        base_params: Any = None,
    ) -> HierarchyFoldReport:
        """One full hierarchical round: group by region, fold each
        region's cohort through its own engine, then fold the partial
        sums at the parent.  ``base_params`` (the round's global
        weights) is required — every level folds deltas against it."""
        if base_params is None:
            raise ValueError(
                "hierarchical folds need base_params: partial sums "
                "compose only against a shared delta base"
            )
        schedule = schedule if schedule is not None else InstantSchedule()
        grouped: Dict[str, List[ClientResult]] = {
            rid: [] for rid in self._regions
        }
        for res in results:
            cid = str(res.client_id)
            rid = self._region_of.get(cid)
            if rid is None:
                raise KeyError(f"client {cid!r} is not mapped to any region")
            grouped[rid].append(res)

        region_reports: Dict[str, FoldReport] = {}
        partials: List[PartialSum] = []
        span = 0.0
        for rid, region in self._regions.items():
            rres = grouped[rid]
            if not rres:
                # No cohort member this round; the region's carry (if
                # any) waits for its next populated round.
                continue
            rep = region.fold_region(round_idx, rres, schedule, base_params)
            region_reports[rid] = rep
            assert rep.partial is not None
            partials.append(rep.partial)
            span = max(span, rep.round_span_s)
            self.bus.publish(
                RegionClosed(rep.round_span_s, round_idx, rid,
                             rep.round_span_s, n_folded=len(rep.events),
                             carried_over=tuple(rep.carried_over))
            )
        if not partials:
            raise ValueError("no region folded any update this round")

        t0 = time.monotonic()
        params = self.fold_partials(round_idx, partials, base_params, now_s=span)
        synchronize(tree_device(params))
        parent_fold = time.monotonic() - t0

        deadlines = [
            r.deadline_s for r in region_reports.values()
            if r.deadline_s is not None
        ]
        events = [e for rep in region_reports.values() for e in rep.events]
        fold_times = {
            cid: t
            for rep in region_reports.values()
            for cid, t in rep.fold_times.items()
        }
        busy = sum(r.busy_s for r in region_reports.values()) + parent_fold
        total_span = span + parent_fold
        return HierarchyFoldReport(
            params=params,
            events=events,
            excluded=[c for r in region_reports.values() for c in r.excluded],
            rerequested=[
                c for r in region_reports.values() for c in r.rerequested
            ],
            fold_times=fold_times,
            round_span_s=total_span,
            busy_s=busy,
            idle_s=max(0.0, total_span - busy),
            barrier_span_s=max(
                (r.barrier_span_s for r in region_reports.values()),
                default=0.0,
            ) + parent_fold,
            deadline_s=max(deadlines) if deadlines else None,
            carried_over=[
                c for r in region_reports.values() for c in r.carried_over
            ],
            carried_in=[
                c for r in region_reports.values() for c in r.carried_in
            ],
            escalations=[
                c for r in region_reports.values() for c in r.escalations
            ],
            region_reports=region_reports,
            partials=partials,
            parent_fold_s=parent_fold,
        )


# ---------------------------------------------------------------------------
# Hierarchical FL server
# ---------------------------------------------------------------------------

class HierarchicalFLServer(AsyncFLServer):
    """An :class:`~repro_torch.federated.async_server.AsyncFLServer` whose
    fold phase runs through a two-level :class:`HierarchyCoordinator`.

    Protocol per round: sample the cohort (when configured), train the
    cohort's clients, fold each region's updates through its own async
    engine, fold the regional partial sums at the parent, then evaluate
    the cohort on the new globals.  Compression (when configured)
    encodes each update as a tagged delta against the round's base,
    exactly as on the flat server.

    ``regions`` is an int (round-robin partition) or an explicit
    ``{region_id: [client_ids]}`` mapping; ``cohort`` a fraction, size,
    or :class:`CohortSampler`; ``sharded=True`` reduces the parent's
    partial stack with an all-reduce over ``mesh`` (or the default
    process group).  The params live on ``device`` (the card unless the
    caller asks for the CPU), as on the flat server."""

    def __init__(
        self,
        clients: Sequence[Any],
        initial_params: Any,
        schedule: Optional[ArrivalSchedule] = None,
        regions: Union[int, Mapping[str, Sequence[str]]] = 4,
        cohort: Union[None, float, int, CohortSampler] = None,
        cohort_seed: int = 0,
        sharded: bool = False,
        mesh: Optional[Any] = None,
        on_revocation: str = "rerequest",
        recovery_delay_s: float = 0.0,
        max_rerequests: int = 1,
        fold_cost_s: Optional[float] = None,
        round_deadline: Optional[RoundDeadline] = None,
        carry_discount: float = 0.5,
        escalate_after: int = 2,
        on_straggler: Optional[Any] = None,
        compression: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            clients, initial_params, schedule=schedule,
            on_revocation=on_revocation, recovery_delay_s=recovery_delay_s,
            max_rerequests=max_rerequests, fold_cost_s=fold_cost_s,
            round_deadline=round_deadline, carry_discount=carry_discount,
            escalate_after=escalate_after, on_straggler=on_straggler,
            compression=compression, **kwargs,
        )
        region_map = partition_regions(
            [str(c.client_id) for c in self.clients], regions
        )
        self.coordinator = HierarchyCoordinator(
            region_map,
            agg_engine=self.agg_engine,
            sampler=as_cohort_sampler(cohort, seed=cohort_seed),
            deadline=round_deadline,
            carry_discount=carry_discount,
            escalate_after=escalate_after,
            on_revocation=on_revocation,
            recovery_delay_s=recovery_delay_s,
            max_rerequests=max_rerequests,
            fold_cost_s=fold_cost_s,
            sharded=sharded,
            mesh=mesh,
            bus=self.bus,
            schema=self._schema,
            staleness_policy=self._staleness_policy,
        )

    @property
    def region_ids(self) -> List[str]:
        return self.coordinator.region_ids

    def _run_round(self, round_idx: int, restarted_from: Optional[str]) -> Any:
        # Narrow the round to its sampled cohort: training, folding,
        # evaluation, and client checkpointing all run over the cohort
        # (RoundDispatched, published before sampling, reports the full
        # population the round could have drawn from).
        population = self.clients
        cohort = set(
            self.coordinator.cohort_for(
                round_idx, [str(c.client_id) for c in population]
            )
        )
        self.clients = [c for c in population if str(c.client_id) in cohort]
        try:
            return super()._run_round(round_idx, restarted_from)
        finally:
            self.clients = population

    def _fold_phase(
        self, round_idx: int, results: Sequence[ClientResult]
    ) -> FoldReport:
        # The hierarchy always folds in flat/delta mode (partial sums
        # compose only against a shared base), so the round's dispatched
        # globals are the base whether or not the wire is compressed.
        base = self.params
        if self._schema is not None:
            results = [
                dataclasses.replace(
                    r,
                    params=self._structured_encoder_for(r.client_id).encode(
                        base, r.params, base_round=round_idx
                    ),
                )
                for r in results
            ]
        elif self._compression is not None:
            results = [
                dataclasses.replace(
                    r,
                    params=self._compressor_for(r.client_id).encode(
                        base, r.params, base_round=round_idx
                    ),
                )
                for r in results
            ]
        report = self.coordinator.fold_round(
            round_idx, results, self.schedule, base_params=base
        )
        self.fold_reports.append(report)
        if self.on_straggler is not None:
            for cid in report.escalations:
                self.on_straggler(cid, round_idx)
        return report
