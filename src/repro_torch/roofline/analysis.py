"""Three-term roofline from a dry-run's counts, a copy of the reference's
``repro/roofline/analysis.py`` (which imports no JAX) whose denominators
are the H100 table in ``hardware.py``.

  compute    = HLO_FLOPs / (chips * peak_FLOP/s)
  memory     = HLO_bytes / (chips * HBM_bw)
  collective = collective_bytes / link_bw   (bytes already per chip)

HLO_FLOPs / HLO_bytes come from `compiled.cost_analysis()` (whole-program,
all chips). collective_bytes is parsed from the post-SPMD optimized HLO
(`compiled.as_text()`): we sum the result-buffer sizes of every
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute.
Post-partitioning shapes are per-device shards, so the sum approximates
bytes crossing one device's links; all-reduce counts twice
(reduce-scatter + all-gather phases of a ring).

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) gives the useful-compute
ratio — the remat/redundancy-waste detector.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from . import hardware

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# e.g.  %all-reduce.5 = bf16[16,512]{1,0} all-reduce(
#       %ag = (f32[4,8]{1,0}, f32[2]{0}) all-gather(
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    counts: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    bytes_by_kind: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    seen_done: set = set()
    for m in _OP_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2)
        # async pairs (-start/-done) would double count; count -start only.
        if m.group(0).rstrip("(").endswith("-done"):
            continue
        b = _shape_bytes(shape_str)
        if kind == "all-reduce":
            b *= 2  # ring all-reduce = reduce-scatter + all-gather
        counts[kind] += 1
        bytes_by_kind[kind] += b
    return CollectiveStats(counts=counts, bytes_by_kind=bytes_by_kind)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None
    collectives: Optional[CollectiveStats] = None
    peak_memory_per_chip: Optional[float] = None

    def to_row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.n_chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "peak_memory_per_chip": self.peak_memory_per_chip,
        }


def roofline(
    arch: str,
    shape: str,
    mesh_desc: str,
    n_chips: int,
    cost_analysis: Dict[str, float],
    hlo_text: str,
    model_flops: Optional[float] = None,
    peak_memory_per_chip: Optional[float] = None,
) -> RooflineReport:
    flops = float(cost_analysis.get("flops", 0.0))
    byts = float(cost_analysis.get("bytes accessed", 0.0))
    colls = parse_collectives(hlo_text)
    # cost_analysis is whole-program (sum over chips); HLO text shapes are
    # per-shard, so collective bytes are already per-chip.
    compute_s = flops / (n_chips * hardware.PEAK_FLOPS_BF16)
    memory_s = byts / (n_chips * hardware.HBM_BANDWIDTH)
    collective_s = colls.total_bytes / hardware.ICI_LINK_BANDWIDTH
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_desc,
        n_chips=n_chips,
        hlo_flops=flops,
        hlo_bytes=byts,
        collective_bytes=float(colls.total_bytes),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops) if (model_flops and flops) else None,
        collectives=colls,
        peak_memory_per_chip=peak_memory_per_chip,
    )


def model_flops_estimate(n_params_active: int, n_tokens: int, kind: str) -> float:
    """6·N·D for a train step (fwd+bwd), 2·N·D for inference forward."""
    if kind == "train":
        return 6.0 * n_params_active * n_tokens
    return 2.0 * n_params_active * n_tokens
