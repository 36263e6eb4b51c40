"""Environment model (paper §3).

This is the port's own copy of ``repro/core/cloud_model.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

A multi-cloud platform: providers -> regions -> VM instance types, with
per-provider egress cost (cost_t_j, $/GB), per-provider and per-region
GPU/vCPU capacity bounds, and per-VM fixed cost ($/s) for on-demand and
spot markets.

All monetary values are USD; all times are seconds unless noted.

Spot prices need not be the static `VMType.cost_spot_hour` constants:
the :class:`PriceFeed` family models time-varying spot markets — a
seeded synthetic walk (:class:`SyntheticSpotFeed`) or a replayable
recorded trace (:class:`SpotPriceTrace` / :class:`TracePriceFeed`) —
which the cost autopilot (`repro.core.autopilot`) threads through the
cost model and the billing ledger.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
from typing import Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class VMType:
    """An instance type vm_{jkl} available in one region."""

    vm_id: str                 # e.g. "vm_126"
    name: str                  # e.g. "c240g5"
    provider: str              # provider id p_j
    region: str                # region id r_jk
    vcpus: int                 # cpu_{jkl}
    gpus: int                  # gpu_{jkl}
    ram_gb: float
    cost_on_demand_hour: float  # $/hour on-demand
    cost_spot_hour: float       # $/hour spot (preemptible)

    def cost_per_second(self, market: str = "on_demand") -> float:
        """cost_{jkl}: fixed $/s."""
        if market == "on_demand":
            return self.cost_on_demand_hour / 3600.0
        if market == "spot":
            return self.cost_spot_hour / 3600.0
        raise ValueError(f"unknown market {market!r}")


@dataclasses.dataclass(frozen=True)
class Region:
    """Region r_jk of provider p_j with local capacity bounds."""

    region_id: str
    provider: str
    max_gpus: Optional[int] = None    # N_L_GPU_jk (None = unbounded)
    max_vcpus: Optional[int] = None   # N_L_CPU_jk


@dataclasses.dataclass(frozen=True)
class Provider:
    """Cloud provider p_j."""

    provider_id: str
    cost_transfer_gb: float           # cost_t_j, $/GB sent from this provider
    max_gpus: Optional[int] = None    # N_GPU_j
    max_vcpus: Optional[int] = None   # N_CPU_j


class CloudEnvironment:
    """The full multi-cloud environment: P, R_j, V_jk and slowdown tables.

    Slowdowns are produced by the Pre-Scheduling module (paper §4.1) and
    attached here so the Initial Mapping / Dynamic Scheduler can read
    sl_comm[(region_a, region_b)] and sl_inst[vm_id].
    """

    def __init__(
        self,
        providers: Iterable[Provider],
        regions: Iterable[Region],
        vm_types: Iterable[VMType],
    ) -> None:
        self.providers: Dict[str, Provider] = {p.provider_id: p for p in providers}
        self.regions: Dict[str, Region] = {r.region_id: r for r in regions}
        self.vm_types: Dict[str, VMType] = {v.vm_id: v for v in vm_types}
        for vm in self.vm_types.values():
            if vm.provider not in self.providers:
                raise ValueError(f"VM {vm.vm_id} references unknown provider {vm.provider}")
            if vm.region not in self.regions:
                raise ValueError(f"VM {vm.vm_id} references unknown region {vm.region}")
        for r in self.regions.values():
            if r.provider not in self.providers:
                raise ValueError(f"region {r.region_id} references unknown provider {r.provider}")
        # Slowdown tables (filled by PreScheduling.attach_to_environment).
        self.sl_comm: Dict[Tuple[str, str], float] = {}
        self.sl_inst: Dict[str, float] = {}

    # -- lookups -----------------------------------------------------------
    def vms_in_region(self, region_id: str) -> List[VMType]:
        return [v for v in self.vm_types.values() if v.region == region_id]

    def regions_of(self, provider_id: str) -> List[Region]:
        return [r for r in self.regions.values() if r.provider == provider_id]

    def all_vms(self) -> List[VMType]:
        return list(self.vm_types.values())

    def comm_slowdown(self, region_a: str, region_b: str) -> float:
        """sl_comm_{jklm}; symmetric lookup."""
        key = (region_a, region_b)
        if key in self.sl_comm:
            return self.sl_comm[key]
        rkey = (region_b, region_a)
        if rkey in self.sl_comm:
            return self.sl_comm[rkey]
        raise KeyError(f"no communication slowdown for {key}")

    def inst_slowdown(self, vm_id: str) -> float:
        return self.sl_inst[vm_id]

    def transfer_cost_gb(self, provider_id: str) -> float:
        return self.providers[provider_id].cost_transfer_gb


# ---------------------------------------------------------------------------
# Published testbeds (paper Tables 2, 3, 4 and 9) — reproduced verbatim so the
# scheduler can be validated against the paper's reported outcomes.
# ---------------------------------------------------------------------------

def cloudlab_environment() -> CloudEnvironment:
    """The CloudLab two-cloud testbed of Table 2 with Table 3/4 slowdowns."""
    providers = [
        # Transfer cost assumed equal to GCP's $0.012/GB in the paper (§5.4).
        Provider("cloud_a", cost_transfer_gb=0.012),
        Provider("cloud_b", cost_transfer_gb=0.012),
    ]
    regions = [
        Region("cloud_a_utah", "cloud_a"),
        Region("cloud_a_wisconsin", "cloud_a"),
        Region("cloud_a_clemson", "cloud_a"),
        Region("cloud_b_apt", "cloud_b"),
        Region("cloud_b_mass", "cloud_b"),
    ]
    # (vm_id, name, region, vcpus, gpus, ram, on_demand $/h, spot $/h)
    rows = [
        ("vm_112", "c6525-25g", "cloud_a_utah", 32, 0, 128, 1.670, 0.501),
        ("vm_114", "m510", "cloud_a_utah", 16, 0, 64, 0.835, 0.250),
        ("vm_115", "xl170", "cloud_a_utah", 20, 0, 64, 0.971, 0.291),
        ("vm_121", "c220g1", "cloud_a_wisconsin", 32, 0, 128, 1.670, 0.501),
        ("vm_122", "c220g2", "cloud_a_wisconsin", 40, 0, 160, 2.087, 0.626),
        ("vm_124", "c240g1", "cloud_a_wisconsin", 32, 0, 128, 1.670, 0.501),
        ("vm_126", "c240g5", "cloud_a_wisconsin", 40, 1, 192, 4.693, 1.408),
        ("vm_135", "dss7500", "cloud_a_clemson", 24, 0, 128, 1.398, 0.419),
        ("vm_138", "r7525", "cloud_a_clemson", 128, 1, 512, 11.159, 3.348),
        ("vm_211", "c6220", "cloud_b_apt", 32, 0, 64, 1.283, 0.385),
        ("vm_212", "r320", "cloud_b_apt", 12, 0, 16, 0.574, 0.172),
        ("vm_221", "rs440", "cloud_b_mass", 64, 0, 192, 2.837, 0.851),
        ("vm_222", "rs630", "cloud_b_mass", 40, 0, 256, 2.349, 0.705),
    ]
    vms = [
        VMType(vm_id, name, _region_provider(region), region, vcpus, gpus, ram, od, spot)
        for vm_id, name, region, vcpus, gpus, ram, od, spot in rows
    ]
    env = CloudEnvironment(providers, regions, vms)
    env.sl_inst = dict(CLOUDLAB_INST_SLOWDOWNS)
    env.sl_comm = dict(CLOUDLAB_COMM_SLOWDOWNS)
    return env


def _region_provider(region_id: str) -> str:
    return "cloud_a" if region_id.startswith("cloud_a") else "cloud_b"


# Table 3 — execution slowdowns (baseline vm_121).
CLOUDLAB_INST_SLOWDOWNS: Dict[str, float] = {
    "vm_112": 1.064,
    "vm_114": 1.422,
    "vm_115": 0.984,
    "vm_121": 1.000,
    "vm_122": 1.162,
    "vm_124": 0.970,
    "vm_126": 0.045,
    "vm_135": 1.087,
    "vm_138": 0.568,
    "vm_211": 1.268,
    "vm_212": 2.328,
    "vm_221": 0.814,
    "vm_222": 0.916,
}

# Table 4 — communication slowdowns (baseline cloud_b_apt <-> cloud_b_apt).
CLOUDLAB_COMM_SLOWDOWNS: Dict[Tuple[str, str], float] = {
    ("cloud_b_apt", "cloud_b_apt"): 1.000,
    ("cloud_b_apt", "cloud_a_clemson"): 2.078,
    ("cloud_b_apt", "cloud_b_mass"): 18.641,
    ("cloud_b_apt", "cloud_a_utah"): 0.857,
    ("cloud_b_apt", "cloud_a_wisconsin"): 2.752,
    ("cloud_a_clemson", "cloud_a_clemson"): 0.954,
    ("cloud_a_clemson", "cloud_b_mass"): 12.464,
    ("cloud_a_clemson", "cloud_a_utah"): 1.932,
    ("cloud_a_clemson", "cloud_a_wisconsin"): 1.175,
    ("cloud_b_mass", "cloud_b_mass"): 0.929,
    ("cloud_b_mass", "cloud_a_utah"): 14.092,
    ("cloud_b_mass", "cloud_a_wisconsin"): 24.731,
    ("cloud_a_utah", "cloud_a_utah"): 0.372,
    ("cloud_a_utah", "cloud_a_wisconsin"): 3.738,
    ("cloud_a_wisconsin", "cloud_a_wisconsin"): 1.022,
}


def aws_gcp_environment() -> CloudEnvironment:
    """The AWS/GCP proof-of-concept testbed of Table 9 (§5.7).

    Slowdowns for this environment were published in the prior paper [1];
    here we use equivalence classes: GPUs of the same generation get the same
    slowdown (paper §5.6.1 discussion), CPU VMs scale with vCPU count.
    """
    providers = [
        Provider("aws", cost_transfer_gb=0.09),   # AWS egress
        Provider("gcp", cost_transfer_gb=0.012),  # GCP egress (paper §5.4)
    ]
    regions = [
        Region("aws_us_east_1", "aws", max_gpus=4),
        Region("gcp_us_central1", "gcp", max_gpus=4),
        Region("gcp_us_west1", "gcp", max_gpus=4),
    ]
    rows = [
        ("vm_311", "g4dn.2xlarge", "aws_us_east_1", 8, 1, 32, 0.752, 0.318),
        ("vm_312", "g3.4xlarge", "aws_us_east_1", 16, 1, 122, 1.140, 0.638),
        ("vm_313", "t2.xlarge", "aws_us_east_1", 4, 0, 16, 0.186, 0.140),
        ("vm_411", "n1-standard-8-turing", "gcp_us_central1", 8, 1, 30, 0.730, 0.196),
        ("vm_413", "n1-standard-8-volta", "gcp_us_central1", 8, 1, 30, 2.860, 0.857),
        ("vm_414", "e2-standard-4", "gcp_us_central1", 4, 0, 16, 0.134, 0.040),
        ("vm_422", "n1-standard-8-volta", "gcp_us_west1", 8, 1, 30, 2.860, 0.857),
        ("vm_423", "e2-standard-4", "gcp_us_west1", 4, 0, 16, 0.134, 0.040),
    ]
    vms = [
        VMType(vm_id, name, region.split("_")[0], region, vcpus, gpus, ram, od, spot)
        for vm_id, name, region, vcpus, gpus, ram, od, spot in rows
    ]
    env = CloudEnvironment(providers, regions, vms)
    # Execution slowdowns: baseline = g4dn.2xlarge (Turing T4). Volta ~ 0.8x,
    # M60 ~ 1.6x, CPU-only VMs far slower on CNN training.
    env.sl_inst = {
        "vm_311": 1.000,
        "vm_312": 1.600,
        "vm_313": 12.000,
        "vm_411": 1.000,
        "vm_413": 0.800,
        "vm_414": 12.000,
        "vm_422": 0.800,
        "vm_423": 12.000,
    }
    # Communication slowdowns: baseline = intra-AWS-region.
    env.sl_comm = {
        ("aws_us_east_1", "aws_us_east_1"): 1.000,
        ("aws_us_east_1", "gcp_us_central1"): 4.000,
        ("aws_us_east_1", "gcp_us_west1"): 5.000,
        ("gcp_us_central1", "gcp_us_central1"): 1.000,
        ("gcp_us_central1", "gcp_us_west1"): 2.500,
        ("gcp_us_west1", "gcp_us_west1"): 1.000,
    }
    return env


# ---------------------------------------------------------------------------
# Time-varying spot prices: feeds and replayable traces.
#
# The paper treats cost_{jkl} as a constant; real spot markets move.  A
# PriceFeed answers "what does this VM's spot market charge at time t"
# and "what does occupying it over [t0, t1] cost" — the cost autopilot
# (repro.core.autopilot) wires one into the CostModel and the
# simulator's billing ledger.  On-demand prices stay fixed constants on
# every feed (that is what on-demand means).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PricePoint:
    """One observed spot quote: from ``time_s`` on, ``vm_id`` costs
    ``price_per_hour`` $/h (piecewise-constant until the next point)."""

    time_s: float
    vm_id: str
    price_per_hour: float


@dataclasses.dataclass(frozen=True)
class SpotPriceTrace:
    """A replayable spot-price history: per-VM piecewise-constant steps.

    The JSON form (`to_json`/`from_json`) is the interchange format —
    a synthetic walk exported with `SyntheticSpotFeed.trace()` replays
    bit-identically through a :class:`TracePriceFeed`."""

    points: Tuple[PricePoint, ...]

    def __post_init__(self) -> None:
        by_vm: Dict[str, float] = {}
        for p in self.points:
            if p.price_per_hour <= 0.0:
                raise ValueError(f"non-positive price for {p.vm_id}: {p.price_per_hour}")
            if p.time_s < by_vm.get(p.vm_id, 0.0):
                raise ValueError(f"trace points for {p.vm_id} not time-sorted")
            by_vm[p.vm_id] = p.time_s

    def for_vm(self, vm_id: str) -> List[PricePoint]:
        return [p for p in self.points if p.vm_id == vm_id]

    def to_json(self) -> str:
        return json.dumps({
            "points": [dataclasses.asdict(p) for p in self.points]
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SpotPriceTrace":
        data = json.loads(text)
        return cls(points=tuple(
            PricePoint(float(p["time_s"]), str(p["vm_id"]),
                       float(p["price_per_hour"]))
            for p in data["points"]
        ))


class PriceFeed:
    """Static feed: spot markets sit at the listed `VMType.cost_spot_hour`.

    Subclasses override :meth:`spot_price_per_hour` (and, when the
    piecewise structure allows a cheaper integral, :meth:`cost_between`).
    All feeds are deterministic and random-access in time: querying
    t=900 then t=300 returns the same prices as querying in order."""

    def spot_price_per_hour(self, vm: VMType, now_s: float) -> float:
        return vm.cost_spot_hour

    def price_per_second(self, vm: VMType, market: str, now_s: float) -> float:
        """Time-varying cost_{jkl}: $/s for ``vm`` on ``market`` at ``now_s``."""
        if market == "on_demand":
            return vm.cost_on_demand_hour / 3600.0
        if market == "spot":
            return self.spot_price_per_hour(vm, now_s) / 3600.0
        raise ValueError(f"unknown market {market!r}")

    def cost_between(
        self, vm: VMType, market: str, t0: float, t1: float
    ) -> float:
        """$ charged for occupying ``vm`` over [t0, t1] (piecewise exact)."""
        if t1 <= t0:
            return 0.0
        if market == "on_demand":
            return (vm.cost_on_demand_hour / 3600.0) * (t1 - t0)
        return self._spot_cost_between(vm, t0, t1)

    def _spot_cost_between(self, vm: VMType, t0: float, t1: float) -> float:
        return (self.spot_price_per_hour(vm, t0) / 3600.0) * (t1 - t0)


class SyntheticSpotFeed(PriceFeed):
    """Seeded mean-reverting spot-price walk around each VM's listed price.

    Each VM's market moves independently on ``step_s`` ticks: the
    log-multiplier follows an AR(1) walk (``l' = (1 - reversion) * l +
    sigma * N(0,1)``) clipped to ``[floor_mult, cap_mult]`` times the
    listed `cost_spot_hour`.  Per-VM streams are seeded by
    ``(seed, vm_id)`` and lazily extended, so prices are deterministic
    and independent of query order — two feeds with the same seed agree
    at every (vm, t) no matter who asked what first."""

    def __init__(
        self,
        seed: int = 0,
        step_s: float = 300.0,
        sigma: float = 0.08,
        reversion: float = 0.15,
        floor_mult: float = 0.4,
        cap_mult: float = 2.5,
    ) -> None:
        if step_s <= 0.0:
            raise ValueError("step_s must be positive")
        if sigma < 0.0:
            raise ValueError("sigma must be >= 0")
        if not 0.0 < reversion <= 1.0:
            raise ValueError("reversion must be in (0, 1]")
        if not 0.0 < floor_mult <= 1.0 <= cap_mult:
            raise ValueError("need floor_mult in (0,1] and cap_mult >= 1")
        self.seed = seed
        self.step_s = float(step_s)
        self.sigma = float(sigma)
        self.reversion = float(reversion)
        self.floor_mult = float(floor_mult)
        self.cap_mult = float(cap_mult)
        self._walks: Dict[str, List[float]] = {}   # vm_id -> multiplier per tick
        self._rngs: Dict[str, random.Random] = {}
        self._logs: Dict[str, float] = {}          # last log-multiplier per vm

    def _multiplier(self, vm_id: str, tick: int) -> float:
        walk = self._walks.setdefault(vm_id, [1.0])
        if vm_id not in self._rngs:
            self._rngs[vm_id] = random.Random(f"{self.seed}:{vm_id}")
            self._logs[vm_id] = 0.0
        rng = self._rngs[vm_id]
        while len(walk) <= tick:
            log_m = (1.0 - self.reversion) * self._logs[vm_id] + self.sigma * rng.gauss(0.0, 1.0)
            self._logs[vm_id] = log_m
            walk.append(min(self.cap_mult, max(self.floor_mult, math.exp(log_m))))
        return walk[tick]

    def spot_price_per_hour(self, vm: VMType, now_s: float) -> float:
        tick = max(0, int(now_s // self.step_s))
        return vm.cost_spot_hour * self._multiplier(vm.vm_id, tick)

    def _spot_cost_between(self, vm: VMType, t0: float, t1: float) -> float:
        # Piecewise-constant integral over the walk's ticks.
        total = 0.0
        t = t0
        while t < t1:
            tick_end = (int(t // self.step_s) + 1) * self.step_s
            seg_end = min(t1, tick_end)
            total += (self.spot_price_per_hour(vm, t) / 3600.0) * (seg_end - t)
            t = seg_end
        return total

    def trace(self, vms: Iterable[VMType], until_s: float) -> SpotPriceTrace:
        """Export the walk over [0, until_s] as a replayable trace."""
        points: List[PricePoint] = []
        for vm in vms:
            last: Optional[float] = None
            n_ticks = int(until_s // self.step_s) + 1
            for tick in range(n_ticks):
                price = vm.cost_spot_hour * self._multiplier(vm.vm_id, tick)
                if last is None or price != last:
                    points.append(PricePoint(tick * self.step_s, vm.vm_id, price))
                    last = price
        points.sort(key=lambda p: (p.time_s, p.vm_id))
        return SpotPriceTrace(points=tuple(points))


class TracePriceFeed(PriceFeed):
    """Replay a recorded :class:`SpotPriceTrace`.

    A VM with no points in the trace stays at its listed spot price;
    before a VM's first point, its first quote applies (the trace is a
    window into an always-trading market, not its opening)."""

    def __init__(self, trace: SpotPriceTrace) -> None:
        self.trace = trace
        self._by_vm: Dict[str, List[PricePoint]] = {}
        for p in trace.points:
            self._by_vm.setdefault(p.vm_id, []).append(p)

    def spot_price_per_hour(self, vm: VMType, now_s: float) -> float:
        points = self._by_vm.get(vm.vm_id)
        if not points:
            return vm.cost_spot_hour
        price = points[0].price_per_hour
        for p in points:
            if p.time_s > now_s:
                break
            price = p.price_per_hour
        return price

    def _spot_cost_between(self, vm: VMType, t0: float, t1: float) -> float:
        points = self._by_vm.get(vm.vm_id)
        if not points:
            return (vm.cost_spot_hour / 3600.0) * (t1 - t0)
        # Breakpoints inside (t0, t1) split the integral.
        cuts = [t0] + [p.time_s for p in points if t0 < p.time_s < t1] + [t1]
        total = 0.0
        for a, b in zip(cuts, cuts[1:]):
            total += (self.spot_price_per_hour(vm, a) / 3600.0) * (b - a)
        return total
