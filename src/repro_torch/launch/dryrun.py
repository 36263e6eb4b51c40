"""Multi-pod dry-run, the port of ``repro/launch/dryrun.py``: prove the
distribution config is coherent without a card, and extract the roofline
terms over the H100 table.

For every (architecture x input shape) the right step function runs on
``torch.device("meta")`` tensors (shapes and dtypes, nothing allocated or
computed) for the production mesh:

  train_4k     -> train_step           (multi-pod: fl_round_step — the
                                        paper's federated round, pods=silos)
  prefill_32k  -> prefill_step
  decode_32k   -> serve_step           (ONE token, 32k KV cache)
  long_500k    -> serve_step           (ONE token, 524k context;
                                        SSM/hybrid native, dense via SWA)

The reference lowers and compiles each step over 256 or 512 forced host
devices and reads XLA's analyses.  The port has nothing to lower; it
counts what the step dispatches instead:

* FLOPs: ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` applies, over every op of the meta run (matmuls,
  batched matmuls, convolutions, attention; elementwise work is not
  counted).  Attention is the wrappers' plain version on ``meta``
  (``kernels/ops.py``), so it counts the full Sq x Sk scores, as the
  reference's plain chunked attention does.
* Bytes: for every op that is neither a view nor an allocation
  (``empty``, which writes nothing), the bytes of every tensor among its
  arguments and outputs.  The count is op by op and unfused, so it
  overstates what a fused step moves.
* The counts are for the global step.  Per chip they are the count over
  the chip count: perfect sharding, no replicated compute (the
  reference's ``cost_analysis()`` is per device after SPMD partitioning).
* Collective bytes per chip come from the PartitionSpec trees
  (``sharding/rules.py``), one rule per term, since there is no HLO to
  parse (:func:`collective_costs`).
* Memory per chip is the bytes of every parameter, optimizer-state,
  cache and input leaf over the product of the mesh axes its spec names.
  Activations and temporaries are left out (there is no
  ``memory_analysis()``), and each row says what was summed in
  ``peak_memory_counts``; ``fits`` is that sum against the H100's 80 GB.

The reference extrapolates from two shallow unrolled probes because XLA
counts a while loop's body once.  The port keeps that arithmetic (F(L) =
a + b*L; F(L, T) bilinear, four probes, for the multi-pod train step) so
that a sweep stays cheap; ``--no-probes`` counts the full-depth step
directly, which in the port is exact.  Row keys the reference fills from
a compile keep their names: ``lower_s`` is the time to build the meta
arguments, ``compile_s`` the time of the counted meta run(s).

No card, no process group and no environment variable is touched.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  python -m repro_torch.launch.dryrun --arch yi-9b            (its four shapes)
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.jsonl]
"""
import argparse
import json
import math
import sys
import time
from typing import Any, Dict, List, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import (
    ARCHITECTURES,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    get_shape,
    long_context_config,
    shape_supported,
)
from ..federated.pod_fedavg import init_pod_state, make_fl_round_step
from ..models import get_model
from ..roofline import CollectiveStats, model_flops_estimate, roofline
from ..roofline.analysis import _COLLECTIVES
from ..roofline.hardware import HBM_BYTES, ICI_LINK_BANDWIDTH
from ..sharding.context import axis_sizes
from ..sharding.rules import _ROW_PARALLEL, _STACKED, PartitionSpec, param_specs
from ..utils.tree import tree_leaves
from .mesh import production_mesh_shape
from .specs import (
    abstract_cache,
    abstract_params,
    decode_cache_specs,
    decode_input_specs,
    prefill_input_specs,
    train_input_specs,
)
from .steps import (
    make_optimizer_for,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    with_compute_mesh,
)

LOCAL_STEPS = 4  # local SGD steps per federated round in the multi-pod step

Shape = Union[str, InputShape]


class SkipShape(Exception):
    pass


class ProductionMesh:
    """The production mesh's axis sizes alone (``.shape``, read by
    ``sharding.context.axis_sizes``): the rules and ``models/moe.py`` read
    sizes only, and no ``DeviceMesh`` (no process group) is built."""

    def __init__(self, multi_pod: bool):
        self.shape = production_mesh_shape(multi_pod)


def _abstract_params(model):
    return abstract_params(model)


def _count_params(abs_params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(abs_params))


def _active_params(cfg: ModelConfig, abs_params) -> int:
    total = _count_params(abs_params)
    if cfg.n_experts == 0:
        return total
    expert = 0
    for leaf in tree_leaves(abs_params):
        shape = tuple(leaf.shape)
        if len(shape) >= 3 and cfg.n_experts in shape[:2]:
            expert += int(leaf.numel())
    return int(total - expert + expert * cfg.top_k / cfg.n_experts)


def _shape(shape: Shape) -> InputShape:
    return get_shape(shape) if isinstance(shape, str) else shape


def resolved_config(arch: str, shape_name: str) -> ModelConfig:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if not shape_supported(cfg, shape):
        raise SkipShape(f"{arch} skips {shape_name} (DESIGN.md §4)")
    if shape_name == "long_500k":
        cfg = long_context_config(cfg)
    return cfg


def build_step(
    cfg: ModelConfig,
    shape_name: Shape,
    multi_pod: bool,
    local_steps: int = LOCAL_STEPS,
):
    """Returns ``(step_fn, meta_args, mesh)``.  ``step_fn.in_specs`` holds
    one PartitionSpec tree per argument (``None`` for a Python value), as
    the reference's ``in_shardings``; the parameters are always argument
    0."""
    shape = _shape(shape_name)
    mesh = ProductionMesh(multi_pod)
    model = get_model(cfg)

    if shape.kind == "train" and multi_pod:
        optimizer = make_optimizer_for(cfg)
        n_pods = mesh.shape["pod"]
        params_mp, opt_mp = init_pod_state(model, optimizer, torch.Generator(), n_pods,
                                           device="meta")
        pspecs_mp = param_specs(params_mp, cfg, mesh, pod_axis=True)
        ospecs_mp = param_specs(opt_mp, cfg, mesh, pod_axis=True)
        batch_abs, bspecs = train_input_specs(
            cfg, shape, pod_axis=True, n_pods=n_pods, local_steps=local_steps
        )
        step = with_compute_mesh(
            make_fl_round_step(model, optimizer, local_steps, unroll=cfg.unroll_layers),
            mesh,
        )
        step.in_specs = (pspecs_mp, ospecs_mp, bspecs)
        return step, (params_mp, opt_mp, batch_abs), mesh

    abs_params = _abstract_params(model)
    pspecs = param_specs(abs_params, cfg, mesh)
    if shape.kind == "train":
        optimizer = make_optimizer_for(cfg)
        abs_opt = optimizer.init(abs_params)
        ospecs = param_specs(abs_opt, cfg, mesh)
        batch_abs, bspecs = train_input_specs(cfg, shape)
        step = with_compute_mesh(
            make_train_step(model, optimizer, microbatches=cfg.microbatches), mesh
        )
        step.in_specs = (pspecs, ospecs, bspecs)
        return step, (abs_params, abs_opt, batch_abs), mesh

    if shape.kind == "prefill":
        batch_abs, bspecs = prefill_input_specs(cfg, shape, pod_axis=multi_pod)
        step = with_compute_mesh(make_prefill_step(model), mesh)
        step.in_specs = (pspecs, bspecs)
        return step, (abs_params, batch_abs), mesh

    # decode
    cache_abs = abstract_cache(model, cfg, shape)
    cspecs = decode_cache_specs(cfg, shape, cache_abs, pod_axis=multi_pod)
    tok_abs, tok_specs = decode_input_specs(cfg, shape, pod_axis=multi_pod)
    step = with_compute_mesh(make_serve_step(model, sliding_window=cfg.sliding_window), mesh)
    # The position is the Python int the serving driver passes, not the
    # spec's 0-d tensor: the decode steps read it with int(pos), which a
    # meta tensor cannot answer, and no shape depends on it.
    pos = shape.seq_len - 1
    step.in_specs = (pspecs, cspecs, tok_specs["token"], None)
    return step, (abs_params, cache_abs, tok_abs["token"], pos), mesh


# ---------------------------------------------------------------------------
# Counting a meta run
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bytes_in(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return _nbytes(x)
    if isinstance(x, (list, tuple)):
        return sum(_bytes_in(v) for v in x)
    if isinstance(x, dict):
        return sum(_bytes_in(v) for v in x.values())
    return 0


# Ops that only allocate: they read and write no bytes.  (Counting their
# outputs would also break the linearity in depth the probes rely on:
# ``fused_stacked_tree_reduce`` allocates its buffer rounded up to whole
# blocks.)
_ALLOCATIONS = frozenset({torch.ops.aten.empty, torch.ops.aten.empty_like,
                          torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                          torch.ops.aten.new_empty_strided})


class _Counter(TorchDispatchMode):
    """Counts every op the step dispatches: its FLOPs by
    ``torch.utils.flop_counter``'s formulas (those ``FlopCounterMode``
    applies: matmuls, batched matmuls, convolutions, attention), and, for
    an op that is neither a view nor an allocation, the bytes of every
    tensor among its arguments and outputs.  ``FlopCounterMode`` itself first tries to
    decompose every op, which more than doubles a meta step's time and
    finds nothing to count here: the ops that reach a dispatch mode are
    already decomposed (the tests hold the two counts equal)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and func._overloadpacket not in _ALLOCATIONS:
            self.bytes += _bytes_in(args) + _bytes_in(kwargs) + _bytes_in(out)
        return out


def count_step(step_fn, args) -> Tuple[int, int]:
    """(FLOPs, bytes) of one run of ``step_fn(*args)``, global."""
    with _Counter() as counter:
        step_fn(*args)
    return int(counter.flops), int(counter.bytes)


# ---------------------------------------------------------------------------
# Per-chip memory and collectives from the specs
# ---------------------------------------------------------------------------

def _axes(spec: PartitionSpec) -> List[str]:
    out: List[str] = []
    for entry in spec:
        if entry is not None:
            out.extend(entry if isinstance(entry, tuple) else (entry,))
    return out


def _shards(spec: PartitionSpec, sizes: Dict[str, int], skip: Tuple[str, ...] = ()) -> int:
    """The number of pieces ``spec`` cuts a leaf into over the mesh axes
    it names (those in ``skip`` left out)."""
    return math.prod(sizes[a] for a in _axes(spec) if a not in skip)


def _leaves(specs: Any, tree: Any, path: Tuple[str, ...] = ()):
    """``(path, spec, leaf)`` for every spec of ``specs`` and the leaf at its
    place in ``tree``; paths as ``sharding.rules`` writes them."""
    if isinstance(specs, PartitionSpec):
        yield "/".join(path), specs, tree
    elif isinstance(specs, dict):
        for k in specs:
            yield from _leaves(specs[k], tree[k], path + (str(k),))
    elif isinstance(specs, tuple) and hasattr(specs, "_fields"):
        for f, s, t in zip(specs._fields, specs, tree):
            yield from _leaves(s, t, path + ("." + f,))
    elif isinstance(specs, (list, tuple)):
        for i, (s, t) in enumerate(zip(specs, tree)):
            yield from _leaves(s, t, path + (str(i),))


def per_chip_bytes(specs: Any, tree: Any, mesh: Any) -> float:
    """Each leaf's bytes over the product of the sizes of the mesh axes
    its spec names, summed."""
    sizes = axis_sizes(mesh)
    return float(sum(_nbytes(t) / _shards(s, sizes) for _, s, t in _leaves(specs, tree)))


def collective_costs(
    cfg: ModelConfig, shape: Shape, multi_pod: bool, local_steps: int,
    params: Any, pspecs: Any, token_spec: PartitionSpec, mesh: Any,
) -> CollectiveStats:
    """Collective bytes per chip of one step, from the parameter specs, by
    the reference's five kinds (an all-reduce counted twice, the ring
    convention of ``roofline/analysis.py``).  One rule per term:

    * all-gather: every parameter leaf whose spec names "data" (FSDP) is
      gathered over "data" once a forward pass, and once more in a train
      step's backward; each gather's result is the leaf's bytes over the
      shard count of its other axes.
    * all-reduce: each row-parallel product (``wo``, ``w_down``, ``w2``,
      ``out_proj`` with "model" on its contraction dim) all-reduces its
      output over "model": the chip's tokens x output features in the
      activation dtype, for every layer the leaf stacks, once a forward
      pass and once more in a train step's backward (the column-parallel
      input gradient of the same size).  A chip's tokens are the step's
      tokens over the token input's batch shards; encoder leaves see the
      encoder's frames, decode steps one token a sequence and no encoder.
    * reduce-scatter / all-reduce: a train step reduces every gradient
      over "data": a reduce-scatter into the chip's shard where the leaf
      is FSDP-sharded, else an all-reduce of the chip's shard.
    * all-reduce: the multi-pod round's one FedAvg of every parameter
      shard over "pod", once a round.

    The multi-pod train step repeats the first three terms for each of its
    ``local_steps``.  Expert tensors (expert-parallel) and the caches'
    context-parallel attention add no term."""
    shape = _shape(shape)
    sizes = axis_sizes(mesh)
    train = shape.kind == "train"
    passes = (2 if train else 1) * (local_steps if (multi_pod and train) else 1)
    act_bytes = torch.empty((), dtype=cfg.activation_dtype).element_size()
    B = shape.global_batch
    if shape.kind == "decode":
        dec_tokens, enc_tokens = B, 0
    else:
        dec_tokens = B * (shape.seq_len + (cfg.n_image_tokens if cfg.arch_type == "vlm" else 0))
        enc_tokens = B * cfg.encoder_seq if cfg.arch_type == "encdec" else 0
    batch_shards = _shards(token_spec, sizes)
    lead = 1 if (multi_pod and train) else 0   # the stacked replicas' "pod" dim

    counts = {k: 0 for k in _COLLECTIVES}
    byts = {k: 0.0 for k in _COLLECTIVES}

    fedavg = 0.0

    def add(kind: str, n: int, b: float) -> None:
        counts[kind] += n
        byts[kind] += b

    for path, spec, leaf in _leaves(pspecs, params):
        axes = _axes(spec)
        nb = _nbytes(leaf)
        shard = nb / _shards(spec, sizes)
        # one collective a stacked layer (counts only; bytes are the leaf's)
        stack = leaf.shape[lead] if _STACKED.search(path) and leaf.dim() > lead else 1
        if "data" in axes:
            add("all-gather", stack * passes, passes * nb / _shards(spec, sizes, skip=("data",)))
        name = path.rsplit("/", 1)[-1]
        if (name in _ROW_PARALLEL and leaf.dim() - lead >= 2 and spec[-2] is not None
                and "model" in _axes(PartitionSpec(spec[-2]))):
            tokens = enc_tokens if path.startswith("encoder/") else dec_tokens
            if tokens:
                products = math.prod(leaf.shape[lead:-2])
                out = products * tokens / batch_shards * leaf.shape[-1] * act_bytes
                add("all-reduce", stack * passes, 2 * passes * out)
        if train:
            steps = passes // 2
            if "data" in axes:
                add("reduce-scatter", stack * steps, steps * shard)
            else:
                add("all-reduce", stack * steps, 2 * steps * shard)
        if multi_pod and train:
            fedavg += 2 * shard
    if fedavg:
        add("all-reduce", 1, fedavg)   # one flattened buffer, one all-reduce
    return CollectiveStats(counts=counts, bytes_by_kind=byts)


def _token_spec(step_fn, shape: InputShape) -> PartitionSpec:
    specs = step_fn.in_specs
    return specs[2] if shape.kind == "decode" else specs[-1]["tokens"]


_PEAK_COUNTS = {"train": "params+opt+inputs", "prefill": "params+inputs",
                "decode": "params+cache+inputs"}


def _memory(step_fn, args, mesh, shape: InputShape) -> Tuple[float, str]:
    """(bytes per chip of every argument leaf, what they are)."""
    total = 0.0
    for specs, arg in zip(step_fn.in_specs, args):
        if specs is not None:
            total += per_chip_bytes(specs, arg, mesh)
    return total, _PEAK_COUNTS[shape.kind]


# ---------------------------------------------------------------------------
# Probe-based cost extrapolation
# ---------------------------------------------------------------------------

def _probe_depths(cfg: ModelConfig) -> Tuple[int, int]:
    if cfg.arch_type == "hybrid":
        sb = cfg.attn_period * cfg.moe_every  # superblock length (lcm)
        import math as _m
        sb = sb // _m.gcd(cfg.attn_period, cfg.moe_every)
        return sb, 2 * sb
    if cfg.n_experts and cfg.first_k_dense:
        return cfg.first_k_dense + 1, cfg.first_k_dense + 2
    return 1, 2


def _probe_cfg(cfg: ModelConfig, depth: int) -> ModelConfig:
    kw: Dict[str, Any] = dict(n_layers=depth, unroll_layers=True, microbatches=1)
    if cfg.arch_type == "encdec":
        kw["n_encoder_layers"] = depth
    return cfg.with_overrides(**kw)


def _costs_of(cfg, shape_name, multi_pod, local_steps) -> Dict[str, Any]:
    """Per-chip FLOPs, bytes and collective bytes of one meta run of the
    step, and the collectives by kind.  ``shape_name`` is a name or an
    ``InputShape``."""
    shape = _shape(shape_name)
    step, args, mesh = build_step(cfg, shape, multi_pod, local_steps)
    chips = math.prod(axis_sizes(mesh).values())
    flops, byts = count_step(step, args)
    colls = collective_costs(cfg, shape, multi_pod, local_steps, args[0], step.in_specs[0],
                             _token_spec(step, shape), mesh)
    return {
        "flops": flops / chips,
        "bytes": byts / chips,
        "coll_bytes": float(colls.total_bytes),
        "counts": colls.counts,
    }


def extrapolated_costs(
    cfg: ModelConfig, shape_name: Shape, multi_pod: bool
) -> Dict[str, Any]:
    """F(L) = a + b*L linear extrapolation (bilinear in (L, local_steps)
    for the multi-pod train step)."""
    L1, L2 = _probe_depths(cfg)
    L_full = cfg.n_layers
    shape = _shape(shape_name)
    bilinear = multi_pod and shape.kind == "train"

    if not bilinear:
        c1 = _costs_of(_probe_cfg(cfg, L1), shape_name, multi_pod, LOCAL_STEPS)
        c2 = _costs_of(_probe_cfg(cfg, L2), shape_name, multi_pod, LOCAL_STEPS)
        out: Dict[str, Any] = {}
        for k in ("flops", "bytes", "coll_bytes"):
            b = (c2[k] - c1[k]) / (L2 - L1)
            out[k] = max(c1[k] + b * (L_full - L1), 0.0)
        out["counts"] = {
            kind: int(
                max(
                    c1["counts"][kind]
                    + (c2["counts"][kind] - c1["counts"][kind])
                    / (L2 - L1)
                    * (L_full - L1),
                    0,
                )
            )
            for kind in c1["counts"]
        }
        return out

    # F(L, T) = c0 + c1*L + T*(a + b*L): four probes.
    T1, T2 = 1, 2
    f = {}
    for L in (L1, L2):
        for T in (T1, T2):
            f[(L, T)] = _costs_of(_probe_cfg(cfg, L), shape_name, multi_pod, T)
    out = {}
    for k in ("flops", "bytes", "coll_bytes"):
        # per-step slope in T at each L:
        sT_L1 = f[(L1, T2)][k] - f[(L1, T1)][k]
        sT_L2 = f[(L2, T2)][k] - f[(L2, T1)][k]
        b = (sT_L2 - sT_L1) / (L2 - L1)
        a = sT_L1 - b * L1
        base_L1 = f[(L1, T1)][k] - (a + b * L1) * T1
        base_L2 = f[(L2, T1)][k] - (a + b * L2) * T1
        c1_ = (base_L2 - base_L1) / (L2 - L1)
        c0_ = base_L1 - c1_ * L1
        out[k] = max(c0_ + c1_ * cfg.n_layers + (a + b * cfg.n_layers) * LOCAL_STEPS, 0.0)
    out["counts"] = f[(L2, T2)]["counts"]  # representative (report-only)
    return out


# ---------------------------------------------------------------------------
# Full dry-run of one (arch x shape x mesh)
# ---------------------------------------------------------------------------

def run_dryrun(
    arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
    probes: bool = True,
) -> Dict[str, Any]:
    cfg = resolved_config(arch, shape_name)
    shape = get_shape(shape_name)
    model = get_model(cfg)
    abs_params = _abstract_params(model)
    n_params = _count_params(abs_params)
    n_active = _active_params(cfg, abs_params)
    mesh_desc = "2x16x16" if multi_pod else "16x16"
    n_chips = 512 if multi_pod else 256

    t0 = time.monotonic()
    step, meta_args, mesh = build_step(cfg, shape_name, multi_pod)
    peak, peak_counts = _memory(step, meta_args, mesh, shape)
    t_lower = time.monotonic() - t0

    del step, meta_args
    if probes:
        costs = extrapolated_costs(cfg, shape_name, multi_pod)
    else:
        costs = _costs_of(cfg, shape_name, multi_pod, LOCAL_STEPS)
    t_compile = time.monotonic() - t0 - t_lower

    if shape.kind == "train":
        n_tokens = shape.global_batch * shape.seq_len
        if multi_pod:
            n_tokens *= LOCAL_STEPS
        kind = "train"
    else:
        n_tokens = (
            shape.global_batch * shape.seq_len
            if shape.kind == "prefill"
            else shape.global_batch
        )
        kind = "infer"
    mflops = model_flops_estimate(n_active, n_tokens, kind)

    # the counts are per chip (the global count over the chips).
    report = roofline(
        arch=arch,
        shape=shape_name,
        mesh_desc=mesh_desc,
        n_chips=1,  # per-chip flops/bytes: denominators are per-chip peaks
        cost_analysis={"flops": costs["flops"], "bytes accessed": costs["bytes"]},
        hlo_text="",
        model_flops=mflops / n_chips,  # per-chip share of useful FLOPs
        peak_memory_per_chip=peak,
    )
    # collective bytes: from the per-chip shards of the specs.
    report.collective_bytes = costs["coll_bytes"]
    report.collective_s = costs["coll_bytes"] / ICI_LINK_BANDWIDTH
    terms = {
        "compute": report.compute_s,
        "memory": report.memory_s,
        "collective": report.collective_s,
    }
    report.dominant = max(terms, key=terms.get)

    row = report.to_row()
    row.update(
        mesh=mesh_desc,
        chips=n_chips,
        n_params=n_params,
        n_params_active=n_active,
        n_tokens=n_tokens,
        lower_s=round(t_lower, 1),
        compile_s=round(t_compile, 1),
        collective_counts=costs["counts"],
        fits=bool(peak <= HBM_BYTES),
        kind=shape.kind,
        peak_memory_counts=peak_counts,
    )
    if verbose:
        print(f"== {arch} x {shape_name} [{mesh_desc}] ==")
        print(f"  params          : {n_params:,} (active {n_active:,})")
        print(f"  peak/chip       : {peak/1e9:.2f} GB of {peak_counts} "
              f"({'FITS' if row['fits'] else 'OVER'} 80 GB HBM)")
        print(f"  per-chip cost   : flops={row['hlo_flops']:.3e} bytes={row['hlo_bytes']:.3e} "
              f"coll_bytes={row['collective_bytes']:.3e}")
        print(f"  collectives     : {costs['counts']}")
        print(f"  roofline        : compute={row['compute_s']*1e3:.2f}ms "
              f"memory={row['memory_s']*1e3:.2f}ms collective={row['collective_s']*1e3:.2f}ms "
              f"-> {row['dominant']}-bound")
        if row["useful_ratio"]:
            print(f"  useful FLOPs    : {row['useful_ratio']*100:.1f}%")
        print(f"  build/count     : {t_lower:.1f}s / {t_compile:.1f}s")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="sweep all (arch x shape)")
    ap.add_argument("--no-probes", action="store_true",
                    help="count the full-depth step instead of extrapolating from probes")
    ap.add_argument("--json", default=None, help="append JSON rows to this file")
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for a in sorted(ARCHITECTURES):
            for s in INPUT_SHAPES:
                combos.append((a, s))
    else:
        if not args.arch:
            ap.error("--arch required (or --all)")
        # --arch alone sweeps that architecture's shapes.
        combos = [(args.arch, s) for s in ([args.shape] if args.shape else INPUT_SHAPES)]

    rows = []
    failures = []
    for arch, shape in combos:
        try:
            rows.append(run_dryrun(arch, shape, args.multi_pod, probes=not args.no_probes))
        except SkipShape as e:
            print(f"SKIP {arch} x {shape}: {e}")
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch} x {shape}: {e!r}")
    if args.json and rows:
        with open(args.json, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
