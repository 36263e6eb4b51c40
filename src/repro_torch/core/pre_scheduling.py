"""Pre-Scheduling module (paper §4.1).

This is the port's own copy of ``repro/core/pre_scheduling.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

Runs a dummy application probe on every VM type and between every region
pair, and derives the two slowdown metrics used by the Initial Mapping:

    sl_inst[vm]          = exec_time(vm) / exec_time(baseline_vm)
    sl_comm[(ra, rb)]    = comm_time(ra, rb) / comm_time(baseline_pair)

It also computes the *job baselines* for the actual FL application: the
per-client train/test time on the baseline VM and the message exchange
times on the baseline region pair.

The probes are pluggable: in production they execute a dummy workload on
freshly provisioned VMs; in this repository the `TableProbe` replays the
published measurements (Tables 3 and 4) and `CallableProbe` lets tests
inject synthetic timings. Slowdowns only need recomputation when the
region/VM inventory changes — they are cached on the environment object.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Mapping, Optional, Tuple

from .cloud_model import CloudEnvironment


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """Raw timings from one dummy-application probe."""

    train_time_s: float
    test_time_s: float

    @property
    def total(self) -> float:
        return self.train_time_s + self.test_time_s


class ExecutionProbe:
    """Measures the dummy app's execution time on a VM type."""

    def measure_vm(self, vm_id: str) -> ProbeResult:  # pragma: no cover - interface
        raise NotImplementedError

    def measure_pair(self, region_a: str, region_b: str) -> ProbeResult:  # pragma: no cover
        raise NotImplementedError


class TableProbe(ExecutionProbe):
    """Replays measured probe tables (e.g. the paper's Tables 3 and 4)."""

    def __init__(
        self,
        vm_times: Mapping[str, ProbeResult],
        pair_times: Mapping[Tuple[str, str], ProbeResult],
    ) -> None:
        self._vm = dict(vm_times)
        self._pair = dict(pair_times)

    def measure_vm(self, vm_id: str) -> ProbeResult:
        return self._vm[vm_id]

    def measure_pair(self, region_a: str, region_b: str) -> ProbeResult:
        if (region_a, region_b) in self._pair:
            return self._pair[(region_a, region_b)]
        return self._pair[(region_b, region_a)]


class CallableProbe(ExecutionProbe):
    """Probe backed by callables (used by tests and the simulator)."""

    def __init__(
        self,
        vm_fn: Callable[[str], ProbeResult],
        pair_fn: Callable[[str, str], ProbeResult],
    ) -> None:
        self._vm_fn = vm_fn
        self._pair_fn = pair_fn

    def measure_vm(self, vm_id: str) -> ProbeResult:
        return self._vm_fn(vm_id)

    def measure_pair(self, region_a: str, region_b: str) -> ProbeResult:
        return self._pair_fn(region_a, region_b)


@dataclasses.dataclass
class PreSchedulingResult:
    """Output of the Pre-Scheduling module."""

    baseline_vm: str
    baseline_pair: Tuple[str, str]
    sl_inst: Dict[str, float]
    sl_comm: Dict[Tuple[str, str], float]
    raw_vm_times: Dict[str, ProbeResult]
    raw_pair_times: Dict[Tuple[str, str], ProbeResult]


class PreScheduling:
    """Computes slowdown metrics (run once per environment change)."""

    def __init__(self, env: CloudEnvironment, probe: ExecutionProbe) -> None:
        self.env = env
        self.probe = probe

    def run(
        self,
        baseline_vm: str,
        baseline_pair: Tuple[str, str],
        n_repeats: int = 2,
    ) -> PreSchedulingResult:
        """Probe every VM and region pair; average `n_repeats` runs.

        The paper runs the dummy app twice per VM (Table 3 shows both rounds)
        and uses the mean; we do the same.
        """
        raw_vm: Dict[str, ProbeResult] = {}
        for vm_id in self.env.vm_types:
            runs = [self.probe.measure_vm(vm_id) for _ in range(n_repeats)]
            raw_vm[vm_id] = ProbeResult(
                train_time_s=sum(r.train_time_s for r in runs) / n_repeats,
                test_time_s=sum(r.test_time_s for r in runs) / n_repeats,
            )

        region_ids = sorted(self.env.regions)
        raw_pair: Dict[Tuple[str, str], ProbeResult] = {}
        for ra, rb in itertools.combinations_with_replacement(region_ids, 2):
            raw_pair[(ra, rb)] = self.probe.measure_pair(ra, rb)

        base_exec = raw_vm[baseline_vm].total
        if base_exec <= 0:
            raise ValueError("baseline VM probe time must be positive")
        bp = baseline_pair if baseline_pair in raw_pair else (baseline_pair[1], baseline_pair[0])
        base_comm = raw_pair[bp].total
        if base_comm <= 0:
            raise ValueError("baseline pair probe time must be positive")

        sl_inst = {vm: r.total / base_exec for vm, r in raw_vm.items()}
        sl_comm = {pair: r.total / base_comm for pair, r in raw_pair.items()}
        return PreSchedulingResult(
            baseline_vm=baseline_vm,
            baseline_pair=bp,
            sl_inst=sl_inst,
            sl_comm=sl_comm,
            raw_vm_times=raw_vm,
            raw_pair_times=raw_pair,
        )

    def attach_to_environment(self, result: PreSchedulingResult) -> None:
        """Cache slowdowns on the environment for the downstream modules."""
        self.env.sl_inst = dict(result.sl_inst)
        self.env.sl_comm = dict(result.sl_comm)


def expected_comm_time(
    env: CloudEnvironment,
    train_comm_bl: float,
    test_comm_bl: float,
    region_a: str,
    region_b: str,
) -> float:
    """Eq. 1: t_comm = (train_comm_bl + test_comm_bl) * sl_comm."""
    return (train_comm_bl + test_comm_bl) * env.comm_slowdown(region_a, region_b)


def expected_exec_time(
    env: CloudEnvironment,
    train_bl: float,
    test_bl: float,
    vm_id: str,
) -> float:
    """Eq. 2: t_exec = (train_bl + test_bl) * sl_inst."""
    return (train_bl + test_bl) * env.inst_slowdown(vm_id)
