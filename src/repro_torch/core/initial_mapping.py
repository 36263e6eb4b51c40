"""Initial Mapping module (paper §4.2).

This is the port's own copy of ``repro/core/initial_mapping.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

Solves the MILP of Eqs. 3-18: place the FL server and every client on VM
instances across providers/regions minimizing the normalized weighted
objective  alpha * total_costs/cost_max + (1-alpha) * t_m/T_max  subject to
budget (8), deadline (9), one-VM-per-task (10, 11), provider/region GPU and
vCPU capacity (12-15) and the makespan bound (16).

Solver: exact enumeration over server placements combined with a
makespan-candidate sweep and a branch-and-bound assignment of clients.

Exactness argument: the objective is monotone in the makespan t_m. For the
candidate T equal to the true optimum's makespan, the surrogate objective
(which replaces the realized t_m with the bound T) coincides with the true
objective on the optimum, upper-bounds it elsewhere, and the B&B returns a
surrogate-minimal assignment whose *realized* objective is therefore <= the
optimum's. Sweeping all candidate T values (the distinct achievable client
round times) and keeping the best realized-feasible solution is exact.

A greedy heuristic (`solve_greedy`) is provided for comparison; the paper's
Dynamic Scheduler reuses its structure at re-scheduling time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from .application_model import FLApplication
from .cloud_model import CloudEnvironment, VMType
from .cost_model import SERVER, Assignment, CostModel, Placement, PlacementEvaluation


@dataclasses.dataclass
class MappingSolution:
    placement: Placement
    evaluation: PlacementEvaluation
    feasible: bool
    nodes_explored: int = 0
    candidates_swept: int = 0

    def vm_of(self, task: str) -> str:
        return self.placement[task].vm_id


@dataclasses.dataclass(frozen=True)
class _ClientOption:
    vm_id: str
    round_time: float     # t_exec + t_comm + t_aggreg (constraint 16 LHS)
    rate: float           # $/s in the chosen market
    comm_cost: float      # Eq. 6 against the fixed server provider
    gpus: int
    vcpus: int
    provider: str
    region: str


class _CapacityTracker:
    """Incremental check of constraints 12-15."""

    def __init__(self, env: CloudEnvironment) -> None:
        self.env = env
        self.provider_gpu: Dict[str, int] = {}
        self.provider_cpu: Dict[str, int] = {}
        self.region_gpu: Dict[str, int] = {}
        self.region_cpu: Dict[str, int] = {}

    def fits(self, vm: VMType) -> bool:
        p = self.env.providers[vm.provider]
        r = self.env.regions[vm.region]
        if p.max_gpus is not None and self.provider_gpu.get(vm.provider, 0) + vm.gpus > p.max_gpus:
            return False
        if p.max_vcpus is not None and self.provider_cpu.get(vm.provider, 0) + vm.vcpus > p.max_vcpus:
            return False
        if r.max_gpus is not None and self.region_gpu.get(vm.region, 0) + vm.gpus > r.max_gpus:
            return False
        if r.max_vcpus is not None and self.region_cpu.get(vm.region, 0) + vm.vcpus > r.max_vcpus:
            return False
        return True

    def add(self, vm: VMType) -> None:
        self.provider_gpu[vm.provider] = self.provider_gpu.get(vm.provider, 0) + vm.gpus
        self.provider_cpu[vm.provider] = self.provider_cpu.get(vm.provider, 0) + vm.vcpus
        self.region_gpu[vm.region] = self.region_gpu.get(vm.region, 0) + vm.gpus
        self.region_cpu[vm.region] = self.region_cpu.get(vm.region, 0) + vm.vcpus

    def remove(self, vm: VMType) -> None:
        self.provider_gpu[vm.provider] -= vm.gpus
        self.provider_cpu[vm.provider] -= vm.vcpus
        self.region_gpu[vm.region] -= vm.gpus
        self.region_cpu[vm.region] -= vm.vcpus


class InitialMapping:
    """Exact MILP solver for the initial placement."""

    def __init__(
        self,
        env: CloudEnvironment,
        app: FLApplication,
        alpha: float = 0.5,
        server_market: str = "on_demand",
        client_market: str = "on_demand",
        server_candidates: Optional[Sequence[str]] = None,
        client_candidates: Optional[Mapping[str, Sequence[str]]] = None,
    ) -> None:
        self.env = env
        self.app = app
        self.cost_model = CostModel(env, app, alpha)
        self.alpha = alpha
        self.server_market = server_market
        self.client_market = client_market
        self._server_candidates = (
            list(server_candidates) if server_candidates is not None else sorted(env.vm_types)
        )
        self._client_candidates = client_candidates

    # ------------------------------------------------------------------
    def _options_for_client(
        self, client_id: str, server_vm: VMType
    ) -> List[_ClientOption]:
        cm = self.cost_model
        if self._client_candidates is not None and client_id in self._client_candidates:
            vm_ids: Sequence[str] = self._client_candidates[client_id]
        else:
            vm_ids = sorted(self.env.vm_types)
        t_aggreg = cm.t_aggreg(server_vm.vm_id)
        out = []
        for vm_id in vm_ids:
            vm = self.env.vm_types[vm_id]
            rt = (
                cm.t_exec(client_id, vm_id)
                + cm.t_comm(vm.region, server_vm.region)
                + t_aggreg
            )
            out.append(
                _ClientOption(
                    vm_id=vm_id,
                    round_time=rt,
                    rate=vm.cost_per_second(self.client_market),
                    comm_cost=cm.comm_cost(vm.provider, server_vm.provider),
                    gpus=vm.gpus,
                    vcpus=vm.vcpus,
                    provider=vm.provider,
                    region=vm.region,
                )
            )
        return out

    def solve(self) -> MappingSolution:
        """Exact solve; raises if no feasible placement exists."""
        cm = self.cost_model
        t_round = self.app.t_round  # deadline per round (constraint 9); None = inf
        b_round = self.app.b_round  # budget per round (constraint 8); None = inf
        t_limit = t_round if t_round is not None else math.inf
        b_limit = b_round if b_round is not None else math.inf

        best_obj = math.inf
        best_placement: Optional[Placement] = None
        best_eval: Optional[PlacementEvaluation] = None
        nodes = 0
        candidates_swept = 0

        client_ids = [c.client_id for c in self.app.clients]

        for server_vm_id in self._server_candidates:
            server_vm = self.env.vm_types[server_vm_id]
            server_rate = server_vm.cost_per_second(self.server_market)

            options = {cid: self._options_for_client(cid, server_vm) for cid in client_ids}
            if any(not opts for opts in options.values()):
                continue

            # Candidate makespans: all distinct achievable round times <= deadline.
            times = sorted(
                {o.round_time for opts in options.values() for o in opts if o.round_time <= t_limit}
            )
            # Only candidates that admit a complete assignment matter: T must be
            # >= every client's fastest option.
            min_feasible_t = max(min(o.round_time for o in opts) for opts in options.values())
            times = [t for t in times if t >= min_feasible_t - 1e-12]

            for T in times:
                candidates_swept += 1
                sol, n = self._assign_clients(
                    client_ids, options, server_vm, server_rate, T, b_limit
                )
                nodes += n
                if sol is None:
                    continue
                placement: Placement = {SERVER: Assignment(server_vm_id, self.server_market)}
                for cid, opt in sol.items():
                    placement[cid] = Assignment(opt.vm_id, self.client_market)
                ev = cm.evaluate(placement)
                if ev.makespan_s > t_limit + 1e-9 or ev.total_costs > b_limit + 1e-9:
                    continue
                if ev.objective < best_obj - 1e-15:
                    best_obj = ev.objective
                    best_placement = placement
                    best_eval = ev

        if best_placement is None or best_eval is None:
            raise InfeasibleMappingError(
                "no placement satisfies the budget/deadline/capacity constraints"
            )
        return MappingSolution(
            placement=best_placement,
            evaluation=best_eval,
            feasible=True,
            nodes_explored=nodes,
            candidates_swept=candidates_swept,
        )

    # ------------------------------------------------------------------
    def _assign_clients(
        self,
        client_ids: List[str],
        options: Mapping[str, List[_ClientOption]],
        server_vm: VMType,
        server_rate: float,
        T: float,
        b_limit: float,
    ) -> Tuple[Optional[Dict[str, _ClientOption]], int]:
        """B&B: minimize surrogate cost  sum_i (T*rate_i + comm_i)  over
        feasible options (round_time <= T) under capacity constraints and a
        surrogate budget bound. Returns (assignment, nodes)."""
        feas: Dict[str, List[_ClientOption]] = {}
        for cid in client_ids:
            opts = [o for o in options[cid] if o.round_time <= T + 1e-12]
            if not opts:
                return None, 0
            opts.sort(key=lambda o: T * o.rate + o.comm_cost)
            feas[cid] = opts

        # Order clients by fewest options first (fail fast), then by how much
        # their best option costs (most constrained first).
        order = sorted(client_ids, key=lambda cid: (len(feas[cid]), -(T * feas[cid][0].rate)))
        min_tail = [0.0] * (len(order) + 1)
        for i in range(len(order) - 1, -1, -1):
            o0 = feas[order[i]][0]
            min_tail[i] = min_tail[i + 1] + T * o0.rate + o0.comm_cost

        tracker = _CapacityTracker(self.env)
        if not tracker.fits(server_vm):
            return None, 0
        tracker.add(server_vm)

        fixed_cost = server_rate * T  # server's surrogate VM cost
        best: Dict[str, _ClientOption] = {}
        best_cost = [math.inf]
        nodes = [0]
        chosen: Dict[str, _ClientOption] = {}

        def rec(i: int, acc: float) -> None:
            nodes[0] += 1
            if acc + min_tail[i] >= best_cost[0] - 1e-15:
                return
            if fixed_cost + acc + min_tail[i] > b_limit + 1e-9:
                return
            if i == len(order):
                best_cost[0] = acc
                best.clear()
                best.update(chosen)
                return
            cid = order[i]
            for opt in feas[cid]:
                vm = self.env.vm_types[opt.vm_id]
                if not tracker.fits(vm):
                    continue
                tracker.add(vm)
                chosen[cid] = opt
                rec(i + 1, acc + T * opt.rate + opt.comm_cost)
                del chosen[cid]
                tracker.remove(vm)

        rec(0, 0.0)
        if not best and best_cost[0] is math.inf:
            return None, nodes[0]
        return (dict(best) if best else None), nodes[0]

    # ------------------------------------------------------------------
    def solve_greedy(self) -> MappingSolution:
        """Simple heuristic: per server candidate, give each client its
        objective-best option greedily (capacity-aware), keep the best
        realized placement. Used for comparison and as a fast fallback."""
        cm = self.cost_model
        t_limit = self.app.t_round if self.app.t_round is not None else math.inf
        b_limit = self.app.b_round if self.app.b_round is not None else math.inf
        best_obj = math.inf
        best_placement: Optional[Placement] = None
        best_eval: Optional[PlacementEvaluation] = None
        client_ids = [c.client_id for c in self.app.clients]

        for server_vm_id in self._server_candidates:
            server_vm = self.env.vm_types[server_vm_id]
            tracker = _CapacityTracker(self.env)
            if not tracker.fits(server_vm):
                continue
            tracker.add(server_vm)
            placement: Placement = {SERVER: Assignment(server_vm_id, self.server_market)}
            ok = True
            for cid in client_ids:
                opts = self._options_for_client(cid, server_vm)
                # Greedy score mirrors Algorithm 3's normalized blend.
                opts.sort(
                    key=lambda o: self.alpha
                    * ((o.round_time * o.rate + o.comm_cost) / cm.cost_max())
                    + (1 - self.alpha) * (o.round_time / cm.t_max())
                )
                placed = False
                for o in opts:
                    vm = self.env.vm_types[o.vm_id]
                    if o.round_time <= t_limit and tracker.fits(vm):
                        tracker.add(vm)
                        placement[cid] = Assignment(o.vm_id, self.client_market)
                        placed = True
                        break
                if not placed:
                    ok = False
                    break
            if not ok:
                continue
            ev = cm.evaluate(placement)
            if ev.makespan_s > t_limit + 1e-9 or ev.total_costs > b_limit + 1e-9:
                continue
            if ev.objective < best_obj:
                best_obj = ev.objective
                best_placement = placement
                best_eval = ev

        if best_placement is None or best_eval is None:
            raise InfeasibleMappingError("greedy found no feasible placement")
        return MappingSolution(best_placement, best_eval, True)


class InfeasibleMappingError(RuntimeError):
    pass
