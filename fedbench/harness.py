"""One run of one benchmark cell: set-up, warm-up round, timed window,
optional traced rounds, the check against the plain reference, and the
result.

Everything a cell is made of is found by name: ``BENCHMARK.json`` maps
the workload to a configuration and a traffic mix
(``fedbench/configs/<config>.json``, ``fedbench/traffic/<traffic>.json``),
the configuration names its family (``fedbench/families/<family>.py``,
``fedbench/reference/<family>.py``, ``fedbench/flops/<family>.py``), every
metric is ``fedbench/metrics/<name>.py`` (a per-layer one read in the
cells that report the end-to-end metric it moves) and every kernel's work
``fedbench/work/<kernel>.py``; the check's limits are
``fedbench/limits/<workload>.json``.

The window drives the system's own entry points: ``FLServer.run`` (barrier
traffic) or ``AsyncFLServer.run`` (compressed or structured traffic) over
``FLClient``s, one round a call, with messages measured as the traffic
says and no checkpoints.  The traced rounds run under ``torch.profiler``
with the program's spans on (``repro_torch.utils.spans``), joined with
the trace's device events by ``fedbench/phases.py``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

import torch

from .check import fold_gap, is_correct, readings, verdict
from .reference.common import QBLOCK, Precision, dtype_code, leaves
from .reference.fedavg import STEPS_FOLLOWED, evaluate, fedavg_round, fold_rounds

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# peak_mem_gib is read over the window's first PEAK_ROUNDS rounds, a fixed
# amount of work: AsyncFLServer keeps every round's FoldReport, with its
# weights, so its peak grows a round at a time and a whole window's peak
# would follow how many rounds fit in it.
PEAK_ROUNDS = 5
# The fold stage is checked on this many codec blocks of the shipped
# weights, drawn from the seed (the first and the last always among them).
FOLD_BLOCKS = 1024


def load_json(path: Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """``fedbench/<kind>/<name>.py``, imported by path (a name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod_name = f"fedbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(workload: str, bench: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The workload's entry, configuration, traffic and limits (None where
    the cell has no limits file yet)."""
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    cfg = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else None
    return {"entry": entry, "config": cfg, "traffic": traffic, "limits": limits}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# The program under test, and what set-up's first round records of it
# ---------------------------------------------------------------------------

class Probe:
    """Wraps the system's optimizer and loss for set-up's first round: each
    silo's step losses; its first gradient's norm per trained leaf as the
    optimizer got it (the first moment after one step over 1 - b1); and
    each trained leaf's change after its first STEPS_FOLLOWED steps, as
    the next step's update is handed the parameters.  Disarmed for the
    window, it only passes calls through."""

    def __init__(self, inner: Any, b1: float) -> None:
        self.inner, self.b1 = inner, b1
        self.armed = True
        self.losses: List[List[torch.Tensor]] = []
        self.grad1: List[torch.Tensor] = []
        self.delta3: List[torch.Tensor] = []
        self._start: List[torch.Tensor] = []
        self._steps = 0

    def init(self, params: Any) -> Any:
        from repro_torch.utils.tree import tree_leaves

        if self.armed:
            self.losses.append([])
            self._start, self._steps = tree_leaves(params), 0
        return self.inner.init(params)

    def update(self, grads: Any, state: Any, params: Any):
        from repro_torch.utils.tree import tree_leaves

        if self.armed:
            self._steps += 1
            if self._steps == STEPS_FOLLOWED + 1:
                self.delta3.append(torch.stack([(a.float() - b.float()).norm() for a, b in
                                                zip(tree_leaves(params), self._start)]))
        params, state = self.inner.update(grads, state, params)
        if self.armed and self._steps == 1:
            self.grad1.append(torch.stack([m.float().norm() for m in tree_leaves(state.m)])
                              / (1 - self.b1))
        return params, state

    def loss(self, fn: Callable) -> Callable:
        def recorded(p, b):
            out = fn(p, b)
            if self.armed:
                self.losses[-1].append(out.detach())
            return out

        return recorded


class Blocks:
    """Gathers codec blocks drawn from the seed out of a tree's trained
    leaves (flattened in sorted-key order, as the wire format flattens
    them): a (B, QBLOCK) float32 tensor on the host, the padding zero.

    ``codes`` holds, for each gathered element, the code
    (``reference.common.DTYPES``) of the stored dtype of the leaf it came
    from, (B, QBLOCK) int8, the padding's float32's.  Where the leaves
    hold more than one dtype, the first and the last block of every leaf
    whose dtype is not the one most elements have are always drawn, so
    that a fold that rounds such a leaf to the common dtype is seen."""

    def __init__(self, params: Any, traffic: Dict[str, Any], seed: int) -> None:
        lora = traffic.get("adapters")
        pairs = leaves(params)
        self.trained = [i for i, (path, _) in enumerate(pairs)
                        if lora is None or ".lora_" in path[-1]]
        self.sizes = [pairs[i][1].numel() for i in self.trained]
        kinds = [dtype_code(pairs[i][1].dtype) for i in self.trained]
        ends = torch.tensor(self.sizes, dtype=torch.int64).cumsum(0)
        n = int(ends[-1])
        nb = -(-n // QBLOCK)
        g = torch.Generator().manual_seed(seed % 2 ** 63)
        drawn = torch.randperm(nb, generator=g)[:FOLD_BLOCKS]
        elems: Dict[int, int] = {}
        for k, m in zip(kinds, self.sizes):
            elems[k] = elems.get(k, 0) + m
        common = max(elems, key=elems.get)
        edges = [b for k, m, e in zip(kinds, self.sizes, ends.tolist()) if k != common and m
                 for b in ((e - m) // QBLOCK, (e - 1) // QBLOCK)]
        blocks = torch.cat([drawn, torch.tensor([0, nb - 1] + edges)]).unique()
        pos = blocks[:, None] * QBLOCK + torch.arange(QBLOCK)[None, :]
        self.valid = (pos < n).reshape(-1)
        self.pos = pos.reshape(-1)[self.valid]
        self.shape = tuple(pos.shape)
        codes = torch.zeros(self.valid.numel(), dtype=torch.int8)
        codes[self.valid] = torch.tensor(kinds, dtype=torch.int8)[
            torch.searchsorted(ends, self.pos, right=True)]
        self.codes = codes.view(self.shape)

    @torch.no_grad()
    def __call__(self, tree: Any) -> torch.Tensor:
        pairs = leaves(tree)
        dev = pairs[self.trained[0]][1].device
        pos = self.pos.to(dev)
        vals = torch.empty(pos.numel(), dtype=torch.float32, device=dev)
        off = 0
        for i, m in zip(self.trained, self.sizes):
            lo, hi = (int(torch.searchsorted(pos, x)) for x in (off, off + m))
            vals[lo:hi] = pairs[i][1].reshape(-1)[pos[lo:hi] - off].float()
            off += m
        out = torch.zeros(self.valid.numel(), dtype=torch.float32)
        out[self.valid] = vals.cpu()
        return out.view(self.shape)


class FoldProbe:
    """Installed on the server for set-up's rounds: records, for each
    round's fold, the sampled blocks of the round's global weights, of
    what each silo shipped into it (its weights before any encoding) and
    of the fold's result, with each sampled element's stored dtype."""

    def __init__(self, server: Any, blocks: Blocks) -> None:
        self.server, self.rounds = server, []
        inner = server._fold_phase

        def recorded(round_idx: int, results: Any) -> Any:
            rnd = {"base": blocks(server.params), "dtype": blocks.codes,
                   "silos": [(str(r.client_id), r.n_samples, blocks(r.params)) for r in results]}
            report = inner(round_idx, results)
            rnd["new"] = blocks(report.params)
            self.rounds.append(rnd)
            return report

        server._fold_phase = recorded

    def remove(self) -> None:
        del self.server._fold_phase


def build_program(fam: ModuleType, cfg: Dict[str, Any], traffic: Dict[str, Any], params0: Any,
                  silos: List[Any], device: torch.device):
    """(server, probe): the system's FL server over FLClients, as the
    traffic describes it."""
    from repro_torch.federated import AsyncFLServer, FLClient, FLServer
    from repro_torch.models.fl_models import lora_adapter_schema
    from repro_torch.optim import AdamW, masked

    hp = cfg["optimizer"]
    probe = Probe(AdamW(learning_rate=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                        weight_decay=hp["weight_decay"], state_dtype=hp["state_dtype"]), hp["b1"])
    opt = masked(probe, ".lora_") if traffic.get("adapters") else probe
    loss_fn, eval_fn = fam.program_fns(cfg, traffic)
    clients = [FLClient(s.client_id, s, probe.loss(loss_fn), opt, batch_size=traffic["batch"],
                        local_epochs=traffic["local_epochs"], eval_fn=eval_fn, device=device)
               for s in silos]
    kw = {"measure_round_messages": traffic["measure_messages"], "device": device}
    if traffic["server"] == "barrier":
        if traffic["update"] != "dense" or traffic.get("adapters"):
            raise ValueError("a barrier round folds dense updates of the whole model")
        return FLServer(clients, params0, **kw), probe
    codec = None if traffic["update"] == "dense" else traffic["update"]
    schema = lora_adapter_schema() if traffic.get("adapters") else None
    return AsyncFLServer(clients, params0, compression=codec, schema=schema, **kw), probe


def one_round(server: Any, r: int, device: torch.device) -> Dict[str, Any]:
    """Round ``r`` through the server's own ``run``, timed on the host to
    the device's finish, with its phase times."""
    t0 = time.monotonic()
    server.start_round = r
    rec = server.run(r).rounds[0]
    synchronize(device)
    return {"wall_s": time.monotonic() - t0, "train_s": rec.train_time_s,
            "fold_s": rec.agg_time_s, "eval_s": rec.eval_time_s,
            "checkpoint_s": rec.checkpoint_time_s, "eval_loss": rec.metrics["loss"]}


def leaf_change(new: Any, old: Any) -> torch.Tensor:
    from repro_torch.utils.tree import tree_leaves

    return torch.stack([(a.float() - b.float()).norm()
                        for a, b in zip(tree_leaves(new), tree_leaves(old))]).cpu()


def update_elems(params: Any, traffic: Dict[str, Any]) -> int:
    """Elements of the update a silo ships: the whole model, or its
    adapter leaves."""
    from repro_torch.utils.tree import tree_flatten_with_path, keystr

    return sum(t.numel() for p, t in tree_flatten_with_path(params)[0]
               if not traffic.get("adapters") or ".lora_" in keystr(p))


# ---------------------------------------------------------------------------
# The pieces of a run
# ---------------------------------------------------------------------------

def first_round(spec: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    """Set-up: the cell's weights and silos from the seed, the system's
    server over them, and its first round (the warm-up: every shape of the
    cell, kernels built or loaded), then, where the update carries a codec,
    a second round, whose encode adds each silo's error feedback from the
    first.  Returns the server, the silos and the program's readings of
    those rounds, which the check compares."""
    cfg, traffic = spec["config"], spec["traffic"]
    # Float32 products in float32 (the configurations state no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fam = load_module("families", cfg["family"])
    params0 = fam.make_params(cfg, traffic, seed, device)
    silos = fam.make_silos(cfg, traffic, seed, device)
    server, probe = build_program(fam, cfg, traffic, params0, silos, device)
    fold_probe = FoldProbe(server, Blocks(params0, traffic, seed))
    n_params = sum(t.numel() for t in _leaves(params0))
    warm = one_round(server, 1, device)
    probe.armed = False
    prog = {"losses": [[float(x) for x in s] for s in probe.losses],
            "grad1": torch.stack(probe.grad1).cpu(),
            "delta3": torch.stack(probe.delta3).cpu() if probe.delta3 else torch.zeros(0),
            "delta": leaf_change(server.params, params0), "eval_loss": warm["eval_loss"],
            # The round's weights, kept off the card until the check
            # evaluates them again.
            "params1": tree_map(lambda t: t.detach().to("cpu"), server.params)}
    probe.losses, probe.grad1, probe.delta3, probe._start = [], [], [], []
    if traffic["update"] != "dense":
        one_round(server, 2, device)
    fold_probe.remove()
    return {"fam": fam, "server": server, "silos": silos, "prog": prog, "warm": warm,
            "fold": fold_probe.rounds, "next_round": len(fold_probe.rounds) + 1,
            "n_params": n_params, "n_update": update_elems(params0, traffic)}


def evaluated(spec: Dict[str, Any], params: Any, silos: List[Any], device: torch.device) -> float:
    """The plain reference's evaluation loss of given weights (the check
    of the evaluation stage by itself)."""
    cfg, traffic = spec["config"], spec["traffic"]
    ref_mod = load_module("reference", cfg["family"])
    return evaluate(tree_map(lambda t: t.to(device), params), silos, cfg, traffic,
                    ref_mod.loss, Precision("fp32"))


def reference_round(spec: Dict[str, Any], silos: List[Any], seed: int, device: torch.device,
                    precision: str = "fp32", fault: Optional[str] = None) -> Dict[str, Any]:
    """The plain reference's readings of the same first round, from the
    seed's weights made again."""
    cfg, traffic = spec["config"], spec["traffic"]
    fam = load_module("families", cfg["family"])
    ref_mod = load_module("reference", cfg["family"])
    return fedavg_round(fam.make_params(cfg, traffic, seed, device), silos, cfg, traffic,
                        ref_mod.loss, Precision(precision), fault)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, trace: bool, device: Any = "cuda",
        spec: Optional[Dict[str, Any]] = None, t_start: Optional[float] = None,
        log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)
        ) -> Dict[str, Any]:
    """Run a cell; returns the result object (the last line's content).
    ``spec`` replaces the cell's files (tests at small sizes)."""
    t_start = time.monotonic() if t_start is None else t_start
    device = torch.device(device)
    bench = benchmark()
    spec = spec or cell_spec(workload, bench)
    cfg, traffic = spec["config"], spec["traffic"]
    first = first_round(spec, seed, device)
    server, silos, fam = first["server"], first["silos"], first["fam"]
    synchronize(device)
    setup_s = time.monotonic() - t_start
    log(f"[fedbench] {workload} seed {seed}: set-up {setup_s:.3f} s "
        f"(warm-up round {first['warm']['wall_s']:.3f} s)")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rounds: List[Dict[str, Any]] = []
    r = first["next_round"]
    peak_k = 0
    t0 = time.monotonic()
    while not rounds or time.monotonic() - t0 < seconds:
        rounds.append(one_round(server, r, device))
        r += 1
        if len(rounds) == PEAK_ROUNDS and device.type == "cuda":
            peak_k = torch.cuda.max_memory_allocated(device)
    window_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    peak_k = peak_k or peak
    log(f"[fedbench] window {window_s:.3f} s, {len(rounds)} rounds: "
        + ", ".join(f"{x['wall_s']:.3f}" for x in rounds)
        + f"; peak {peak_k} B over {min(len(rounds), PEAK_ROUNDS)} rounds, {peak} B over all")
    phase = {k: sum(x[k] for x in rounds) / len(rounds) for k in ("train_s", "fold_s", "eval_s")}
    log("[fedbench] phases a round: train (with fold) {train_s:.4f}, fold {fold_s:.4f}, "
        "eval {eval_s:.4f} s".format(**phase))

    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from . import phases
        from .trace import summarize

        try:
            from repro_torch.utils import spans
        except ImportError:   # a program without spans: the metrics that read them stay silent
            spans = None
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        t_rounds = []
        if spans is not None:
            spans.enable()
        with profile(activities=acts) as prof:
            w0 = time.perf_counter_ns()
            tt = time.monotonic()
            for _ in range(traffic["trace_rounds"]):
                t_rounds.append(one_round(server, r, device))
                r += 1
            traced_s = time.monotonic() - tt
            w1 = time.perf_counter_ns()
        traced = dict(summarize(prof), window_s=traced_s, rounds=t_rounds, phases=None)
        if spans is not None:
            taken = spans.take()
            spans.disable()
            traced["phases"] = phases.join(phases.device_busy(phases.device_events(prof)), taken,
                                           (w0 + taken.offset_ns, w1 + taken.offset_ns))
        del prof
        log(f"[fedbench] traced {len(t_rounds)} rounds in {traced_s:.3f} s, device busy "
            f"{traced['busy_s']:.3f} s")
        if traced["phases"]:
            ph = traced["phases"]
            log("[fedbench] traced idle {:.6f} s: ".format(ph["idle_s"]) + ", ".join(
                f"{k} {v:.6f}" for k, v in ph["idle"].items()))

    del server, first["server"]
    free(device)

    # The check: the plain reference's first round from the same seed.
    t_ref = time.monotonic()
    log(f"[fedbench] after the window: {_allocated(device)} GiB still allocated")
    prog = first["prog"]
    numbers = readings(prog, reference_round(spec, silos, seed, device),
                       evaluated(spec, prog["params1"], silos, device),
                       fold_gap(first["fold"], fold_rounds(first["fold"], traffic["update"])))
    log(f"[fedbench] reference round {time.monotonic() - t_ref:.3f} s")
    limits = spec["limits"]
    checks = verdict(numbers, limits if limits else dict.fromkeys(numbers, -math.inf))
    log("[fedbench] readings: " + ", ".join(
        f"{k} {v!r}" + ("" if k in checks else " (not compared)") for k, v in numbers.items()))

    n_params, n_update = first["n_params"], first["n_update"]
    rec = {"workload": workload, "device": device.type, "config": cfg, "traffic": traffic,
           "setup_s": setup_s, "window_s": window_s, "rounds": rounds, "peak_bytes": peak_k,
           "trace": traced, "phases": traced and traced["phases"],
           "peaks": load_json(HERE / "peaks.json"),
           "work": dict(fam.round_work(cfg, traffic),
                        fold={"update": traffic["update"], "silos": len(silos), "elems": n_update}),
           "flops": load_module("flops", cfg["family"]).round_flops(
               cfg, traffic, n_params, n_update if traffic.get("adapters") else n_params)}

    def in_cell(m: Dict[str, Any]) -> bool:
        return workload in m.get("workloads", [workload])

    # A per-layer metric is read where the end-to-end metric it moves is.
    reported = {m["name"] for m in bench["end_to_end"] if in_cell(m)}
    metrics = {}
    for m in bench["per_layer"] if trace else bench["end_to_end"]:
        if not in_cell(m) or ("moves" in m and m["moves"] not in reported):
            continue
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result: Dict[str, Any] = {"correct": is_correct(checks), "attempted": len(rounds),
                              "failed": 0, "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        ops = sorted(traced["device_ops"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(kv) for kv in ops],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    return result


def _allocated(device: torch.device) -> str:
    return f"{torch.cuda.memory_allocated(device) / 2 ** 30:.3f}" if device.type == "cuda" else "-"


def tree_map(fn: Callable, tree: Any) -> Any:
    from repro_torch.utils.tree import tree_map as tm

    return tm(fn, tree)


def _leaves(tree: Any) -> List[torch.Tensor]:
    from repro_torch.utils.tree import tree_leaves

    return tree_leaves(tree)
