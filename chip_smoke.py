#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX
or of the JAX package.  In order it:

  1. prints the card (``nvidia-smi`` name and power limit) and turns TF32
     off for matmuls and cuDNN convolutions;
  2. builds every kernel of the two paths from ``src/repro_torch/kernels/
     csrc`` with nvcc (one process per source, all started together) and
     prints ptxas's registers and shared memory per kernel;
  3. holds each kernel against its plain PyTorch version on the card, over
     the CPU tests' sweep and at the paths' shapes (``dequant_fold`` bit
     for bit, on aligned and misaligned payloads);
  4. times each kernel at its path's shape (CUDA events around each
     launch after warm-up; 4 rounds of 10 launches each of kernel, plain
     version and one PyTorch library call computing the same function,
     in alternating order; median and quartiles) beside its bound, with
     the card's clocks and power after; splits the dense fold at that
     shape into flatten, reduce and unflatten, and the compressed round's
     server work into encode, wire frame and fold;
  5. runs the dense main path at the paper's FEMNIST width
     (``FemnistConfig()``, L = 164,187,070 parameters): 4 silos, 3 FedAvg
     rounds, client and server checkpoints, the server killed at round 3
     and restored from stable storage, message sizes measured;
  6. runs the compressed path at the same width: ``AsyncFLServer`` with
     int8 updates, 4 silos, 2 rounds, then one fp16 round, message sizes
     measured.  For each path every kernel's launch count is set to 0
     just before and read just after;
  7. runs a reduced FEMNIST model on the card and on the CPU (plain
     versions) from the same weights and compares them: 2 dense rounds,
     and 3 int8 rounds with a slow silo parked past a deadline and
     carried into the next round.

Any failed check exits non-zero.  The line before the last is the
``{"kernels": [...]}`` record; the last is ``{"ok": true, "device": ...}``.
Details also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
PAPER_L = 164_187_070       # FemnistConfig() parameter count
N_SILOS = 4
TIMING_ROUNDS = 4       # rounds of kernel / plain / library, order alternating
TIMED_PER_ROUND = 10    # launches of each per round: 40 samples each


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(*parts: object) -> None:
    print(*parts, flush=True)


def cuda_times(fn, n: int) -> list:
    """Device times (ms) of ``n`` calls of ``fn``, each between CUDA events."""
    import torch

    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, n: int, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``n`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    return statistics.median(cuda_times(fn, n))


def quartiles(xs) -> tuple:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return q1, statistics.median(xs), q3


def card_state() -> str:
    """SM and memory clocks, power draw and temperature, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--format=csv,noheader",
         "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def padded_rows(n: int, L: int, dtype, gen):
    """An (N, L) view of an (N, Lp) buffer, Lp a multiple of BLOCK: the
    layout RavelPlan.flatten_stack hands the kernel."""
    import torch
    from repro_torch.kernels.fedavg_reduce import BLOCK

    buf = torch.empty((n, -(-L // BLOCK) * BLOCK), dtype=dtype, device="cuda")
    buf[:, :L] = torch.randn((n, L), generator=gen, device="cuda").to(dtype)
    return buf[:, :L]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    libs = _build.build(["fedavg_reduce", "dequant_fold"])
    say(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} "
        f"in {time.monotonic() - t0:.1f} s")
    for name in libs:
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                say(f"[build] {name}: {line.strip()}")


def phase_kernel_check():
    """Kernel against plain on the card.  Returns the largest error at
    the main path's shape (N = 4, L = 164,187,070, fp32, padded rows)."""
    import torch
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce, fedavg_reduce_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n in (2, 5, 16):
        for L in (100, 8192, 20000):
            for dt in (torch.float32, torch.bfloat16):
                cases.append((n, L, dt, "contiguous"))
    cases += [
        (N_SILOS, PAPER_L, torch.float32, "padded"),      # the main path's call
        (N_SILOS, PAPER_L, torch.float32, "contiguous"),  # odd rows misaligned
        (N_SILOS, PAPER_L, torch.bfloat16, "padded"),
        (16, PAPER_L, torch.float32, "padded"),           # N*L > 2^31
    ]
    main_err = None
    for n, L, dt, layout in cases:
        if layout == "padded":
            x = padded_rows(n, L, dt, gen)
        else:
            x = torch.randn((n, L), generator=gen, device="cuda").to(dt)
        w = torch.rand(n, generator=gen, device="cuda") * 4.5 + 0.5
        got = fedavg_reduce(x, w)
        torch.cuda.synchronize()
        want = fedavg_reduce_plain(x, w)
        tol = 2e-2 if dt == torch.bfloat16 else 2e-5
        check(got.shape == (L,) and got.dtype == dt, f"shape/dtype at N={n} L={L}")
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        say(f"[check] fedavg_reduce N={n} L={L} {str(dt)[6:]} {layout}: "
            f"max|kernel-plain|={err:.3e} (tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
        check(ok, f"fedavg_reduce N={n} L={L} {dt} {layout} within {tol}")
        if (n, L, dt, layout) == (N_SILOS, PAPER_L, torch.float32, "padded"):
            main_err = err
        del x, w, got, want
        torch.cuda.empty_cache()
    return main_err


def phase_kernel_timing():
    import torch
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce, fedavg_reduce_plain

    n, L = N_SILOS, PAPER_L
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = padded_rows(n, L, torch.float32, gen)
    w = torch.rand(n, generator=gen, device="cuda") + 0.5
    w_norm = w / w.sum()
    fns = {
        "kernel": lambda: fedavg_reduce(x, w),
        "plain": lambda: fedavg_reduce_plain(x, w),
        "library": lambda: torch.matmul(w_norm, x),
    }
    for fn in fns.values():
        for _ in range(5):
            fn()
    samples = {k: [] for k in fns}
    for r in range(TIMING_ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            samples[k] += cuda_times(fns[k], TIMED_PER_ROUND)
    state = card_state()
    q = {k: quartiles(v) for k, v in samples.items()}
    ms, plain_ms, library_ms = q["kernel"][1], q["plain"][1], q["library"][1]
    nbytes = (n * L + L) * 4 + n * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2 * n * L / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    for k, name in (("kernel", "fedavg_reduce kernel"), ("plain", "plain version"),
                    ("library", "torch.matmul")):
        say(f"[time] {name} N={n} L={L} fp32: median {q[k][1]:.4f} ms, "
            f"quartiles {q[k][0]:.4f}-{q[k][2]:.4f} ms over {len(samples[k])} launches")
    say(f"[time] bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s); kernel moves "
        f"{nbytes / ms / 1e6:.1f} GB/s = {bound_ms / ms:.1%} of the bound; card after "
        f"timing (clocks.sm, clocks.mem, power.draw, temperature): {state}")
    del x
    torch.cuda.empty_cache()
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "quartiles_ms": q, "card_state": state,
        "bound_ms": bound_ms, "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bytes": nbytes, "achieved_gb_s": nbytes / ms / 1e6,
    }


def phase_fold_breakdown():
    """Where the fold's time goes at paper width: the engine's flatten,
    reduce and unflatten on 4 client trees on the card (CUDA events,
    median of 5 after warm-up), beside the whole ``aggregate`` call."""
    import torch
    from repro_torch.federated.agg_engine import AggregationEngine, plan_for
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn

    gen = torch.Generator(device="cuda").manual_seed(2)
    trees = [init_femnist_cnn(gen, FemnistConfig(), "cuda") for _ in range(N_SILOS)]
    weights = [64.0] * N_SILOS
    engine = AggregationEngine()
    plan = plan_for(trees[0])
    stacked = plan.flatten_stack(trees)
    w = torch.tensor(weights, device="cuda")
    red = engine.reduce_flat(stacked, w)
    parts = {
        "flatten_stack_ms": cuda_ms(lambda: plan.flatten_stack(trees), 5),
        "reduce_ms": cuda_ms(lambda: engine.reduce_flat(stacked, w), 5),
        "unflatten_ms": cuda_ms(lambda: plan.unflatten(red), 5),
        "aggregate_ms": cuda_ms(lambda: engine.aggregate(trees, weights), 5),
    }
    say("[fold] paper-width FEMNIST, 4 silos: " + ", ".join(
        f"{k} {v:.4f}" for k, v in parts.items()))
    del trees, stacked, red
    torch.cuda.empty_cache()
    return parts


def _dequant_inputs(codec: str, n: int, lp: int, gen, offset: int = 0):
    """An int8 or fp16 payload of n elements (``offset`` elements into its
    buffer, so offset 1 is a payload 16-byte misaligned), its scales and
    an fp32 accumulator of lp elements, on the card."""
    import torch
    from repro_torch.kernels.fedavg_reduce import BLOCK

    nb = lp // BLOCK
    if codec == "int8":
        buf = torch.randint(-127, 128, (n + offset,), generator=gen, device="cuda",
                            dtype=torch.int8)
        scales = torch.rand(nb, generator=gen, device="cuda") * 1e-3
    else:
        buf = (torch.randn(n + offset, generator=gen, device="cuda") * 1e-2).half()
        scales = torch.ones(nb, device="cuda")
    acc = torch.randn(lp, generator=gen, device="cuda")
    return acc, buf[offset:], scales


def phase_dequant_check():
    """dequant_fold against its plain version on the card, bit for bit: the
    kernel rounds w*s, (w*s)*x and the sum in fp32 in the plain version's
    order, with __fmul_rn/__fadd_rn so nothing is contracted into an FMA.
    The accumulator's elements past the payload must stay as they were,
    and an accumulator not padded to BLOCK must raise.  Returns the
    largest error at the main path's shape (int8, paper width)."""
    import torch
    from repro_torch.kernels.dequant_fold import dequant_fold, dequant_fold_plain
    from repro_torch.kernels.fedavg_reduce import BLOCK

    gen = torch.Generator(device="cuda").manual_seed(4)
    lp_paper = -(-PAPER_L // BLOCK) * BLOCK
    cases = []
    for codec in ("int8", "fp16"):
        cases += [(codec, BLOCK, BLOCK, 0), (codec, 2 * BLOCK + 123, 3 * BLOCK, 0),
                  (codec, PAPER_L, lp_paper, 0), (codec, 2 * BLOCK + 123, 3 * BLOCK, 1),
                  (codec, PAPER_L, lp_paper, 1)]
    main_err = None
    for codec, n, lp, offset in cases:
        acc, data, scales = _dequant_inputs(codec, n, lp, gen, offset)
        got = acc.clone()
        check(dequant_fold(got, data, scales, 0.75) is got, "dequant_fold returns acc")
        torch.cuda.synchronize()
        want = dequant_fold_plain(acc.clone(), data, scales, 0.75)
        err = (got - want).abs().max().item()
        equal = torch.equal(got, want)
        tail = torch.equal(got[n:], acc[n:])
        say(f"[check] dequant_fold {codec} n={n} Lp={lp} payload offset {offset} "
            f"({'misaligned' if offset else 'aligned'}): max|kernel-plain|={err:.3e} "
            f"bit-equal={equal} tail unchanged={tail} {'ok' if equal and tail else 'FAIL'}")
        check(equal and tail, f"dequant_fold {codec} n={n} offset={offset} equals plain")
        if (codec, n, offset) == ("int8", PAPER_L, 0):
            main_err = err
        del acc, data, scales, got, want
        torch.cuda.empty_cache()
    try:
        dequant_fold(torch.zeros(BLOCK + 1, device="cuda"),
                     torch.zeros(BLOCK + 1, dtype=torch.int8, device="cuda"),
                     torch.ones(1, device="cuda"), 1.0)
        raised = False
    except ValueError as exc:
        raised = "BLOCK" in str(exc)
    say(f"[check] dequant_fold on an unpadded accumulator raises ValueError naming BLOCK: {raised}")
    check(raised, "unpadded accumulator raises")
    return main_err


def phase_dequant_timing():
    """dequant_fold at the compressed path's shape (one paper-width update
    into the round's padded accumulator), int8 and fp16: kernel, plain
    version and ``addcmul_`` in alternating rounds.  ``addcmul_`` needs a
    payload of the accumulator's length, so it gets the payload padded to
    Lp (0.003 % more bytes)."""
    import torch
    from repro_torch.kernels.dequant_fold import dequant_fold, dequant_fold_plain
    from repro_torch.kernels.fedavg_reduce import BLOCK

    n = PAPER_L
    lp = -(-n // BLOCK) * BLOCK
    nb = lp // BLOCK
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for codec in ("int8", "fp16"):
        acc, data, scales = _dequant_inputs(codec, n, lp, gen)
        padded = torch.zeros(lp, dtype=data.dtype, device="cuda")
        padded[:n] = data
        w = 1e-3
        ws = (w * scales)[:, None]
        fns = {
            "kernel": lambda: dequant_fold(acc, data, scales, w),
            "plain": lambda: dequant_fold_plain(acc, data, scales, w),
            "library": lambda: acc.view(nb, BLOCK).addcmul_(padded.view(nb, BLOCK), ws),
        }
        for fn in fns.values():
            for _ in range(5):
                fn()
        samples = {k: [] for k in fns}
        for r in range(TIMING_ROUNDS):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                samples[k] += cuda_times(fns[k], TIMED_PER_ROUND)
        state = card_state()
        q = {k: quartiles(v) for k, v in samples.items()}
        itemsize = data.element_size()
        nbytes = n * (4 + 4 + itemsize) + nb * 4
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = 2 * n / FP32_FLOPS_PER_S * 1e3
        ms = q["kernel"][1]
        for k, name in (("kernel", "dequant_fold kernel"), ("plain", "plain version"),
                        ("library", "addcmul_")):
            say(f"[time] {name} {codec} n={n} into Lp={lp}: median {q[k][1]:.4f} ms, "
                f"quartiles {q[k][0]:.4f}-{q[k][2]:.4f} ms over {len(samples[k])} launches")
        say(f"[time] dequant_fold {codec} bound {max(bound_bytes_ms, bound_ops_ms):.4f} ms "
            f"({nbytes / 1e9:.4f} GB at 3.35 TB/s); kernel moves {nbytes / ms / 1e6:.1f} GB/s "
            f"= {bound_bytes_ms / ms:.1%} of the bound; card after timing: {state}")
        out[codec] = {
            "ms": ms, "plain_ms": q["plain"][1], "library_ms": q["library"][1],
            "quartiles_ms": q, "card_state": state,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "bytes": nbytes, "achieved_gb_s": nbytes / ms / 1e6,
        }
        del acc, data, scales, padded, fns
        torch.cuda.empty_cache()
    return out


def phase_compressed_breakdown():
    """Where the compressed round's server-side time goes at paper width,
    per client update (host clock, each span ending in a synchronize,
    median of 3 after one warm-up): the client's encode (flatten, delta,
    codec, error feedback, on the card), the wire frame
    (``CompressedUpdate.wire_bytes``: device-to-host copy and msgpack,
    which the fold's byte accounting builds once per fold), and the fold
    (``add_compressed`` with the frame size given, i.e. the kernel and its
    set-up)."""
    import torch
    from repro_torch.federated.agg_engine import AggregationEngine
    from repro_torch.federated.compression import ClientCompressor, parse_compression
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.utils.tree import tree_map

    gen = torch.Generator(device="cuda").manual_seed(6)
    base = init_femnist_cnn(gen, FemnistConfig(), "cuda")
    local = tree_map(lambda t: t + 1e-3 * torch.randn(t.shape, generator=gen, device="cuda"),
                     base)

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return time.monotonic() - t0, out

    out = {}
    for codec in ("int8", "fp16"):
        comp = ClientCompressor(parse_compression(codec))
        engine = AggregationEngine()
        spans = {"encode_s": [], "wire_frame_s": [], "fold_s": []}
        for i in range(4):
            t_enc, update = host_s(lambda: comp.encode(base, local, base_round=1))
            t_wire, wire = host_s(lambda: update.wire_bytes)
            agg = engine.streaming(base=base, base_round=1)
            t_fold, _ = host_s(lambda: agg.add(update, 64.0, block=True, wire_bytes=wire))
            if i:  # the first is warm-up
                spans["encode_s"].append(t_enc)
                spans["wire_frame_s"].append(t_wire)
                spans["fold_s"].append(t_fold)
            agg.result()
        med = {k: statistics.median(v) for k, v in spans.items()}
        med["wire_bytes"] = wire
        say(f"[compressed] paper width, {codec}, per update: encode {med['encode_s']:.4f} s, "
            f"wire frame ({wire} B) {med['wire_frame_s']:.4f} s, fold {med['fold_s']:.4f} s")
        out[codec] = med
        del comp, engine, update, agg
        torch.cuda.empty_cache()
    return out


def _femnist_clients(cfg, silos, opt, device):
    from repro_torch.federated import FLClient
    from repro_torch.models.fl_models import femnist_forward, softmax_cross_entropy

    def loss_fn(p, b):
        return softmax_cross_entropy(femnist_forward(p, b[0], cfg), b[1])

    def eval_fn(p, b):
        logits = femnist_forward(p, b[0], cfg)
        n = b[0].shape[0]
        return {"acc_sum": (logits.argmax(-1) == b[1]).float().mean() * n,
                "loss_sum": softmax_cross_entropy(logits, b[1]) * n}

    return [FLClient(s.client_id, s, loss_fn, opt, batch_size=32, eval_fn=eval_fn,
                     device=device) for s in silos]


def phase_main_path(ckpt_root: Path):
    """FLServer at the paper's FEMNIST width on the card."""
    import torch
    from repro_torch.checkpoint import ClientCheckpointManager, ServerCheckpointManager
    from repro_torch.data import make_classification_silos
    from repro_torch.federated import FLServer
    from repro_torch.kernels.dequant_fold import dequant_fold
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves

    cfg = FemnistConfig()
    silos = make_classification_silos(N_SILOS, 62, (28, 28, 1), [(64, 32)] * N_SILOS, seed=0)
    clients = _femnist_clients(cfg, silos, make_optimizer("adamw", 1e-4), "cuda")
    params0 = init_femnist_cnn(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    L = sum(t.numel() for t in tree_leaves(params0))
    check(L == PAPER_L, f"FemnistConfig() has {L} parameters, expected {PAPER_L}")

    sck = ServerCheckpointManager(str(ckpt_root / "server_local"),
                                  str(ckpt_root / "stable_storage"), interval_rounds=2)
    ccks = {c.client_id: ClientCheckpointManager(str(ckpt_root / c.client_id)) for c in clients}

    def fault_hook(round_idx):
        if round_idx == 3:
            # The server VM dies after its round-2 copy reached stable storage.
            sck.wait_for_transfers()
            return "s"
        return None

    launches_after_round = []

    def count_hook(round_idx, params):
        launches_after_round.append(fedavg_reduce.launches)
        return None

    server = FLServer(clients, params0, server_ckpt=sck, client_ckpts=ccks,
                      fault_hook=fault_hook, measure_round_messages=True,
                      post_round_hook=count_hook, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    fedavg_reduce.launches = 0
    dequant_fold.launches = 0
    t0 = time.monotonic()
    res = server.run(3)
    wall = time.monotonic() - t0
    launches = fedavg_reduce.launches
    check(dequant_fold.launches == 0, "no dequant_fold launch on the dense path")

    rounds = []
    for r in res.rounds:
        log = r.message_log
        rounds.append({
            "round": r.round_idx, "loss": r.metrics["loss"], "acc": r.metrics["acc"],
            "agg_time_s": r.agg_time_s, "train_time_s": r.train_time_s,
            "eval_time_s": r.eval_time_s, "checkpoint_time_s": r.checkpoint_time_s,
            "restarted_from": r.restarted_from, "s_msg_train_bytes": log.s_msg_train_bytes,
            "c_msg_test_bytes": log.c_msg_test_bytes,
        })
        say(f"[path] round {r.round_idx}: loss={r.metrics['loss']:.4f} "
            f"acc={r.metrics['acc']:.4f} agg_time_s={r.agg_time_s:.4f} "
            f"train_time_s={r.train_time_s:.3f} eval_time_s={r.eval_time_s:.3f} "
            f"checkpoint_time_s={r.checkpoint_time_s:.3f}"
            + (f" (restored from {r.restarted_from})" if r.restarted_from else ""))
    peak = torch.cuda.max_memory_allocated()
    weight_bytes = res.rounds[-1].message_log.s_msg_train_bytes
    say(f"[path] 3 rounds in {wall:.1f} s; fedavg_reduce launches after each round "
        f"{launches_after_round}; weight message {weight_bytes} B = {L * 4} B of fp32 "
        f"+ {weight_bytes - L * 4} B framing; max_memory_allocated {peak / 2**30:.2f} GiB")

    check(all(t.is_cuda for t in tree_leaves(res.final_params)), "every parameter on cuda")
    check(launches_after_round == [1, 2, 3] and launches == 3,
          f"one fedavg_reduce launch per round, got {launches_after_round}")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["acc"]) for r in rounds),
          "finite losses")
    check(res.rounds[2].restarted_from == "server", "round 3 restored from the server")
    check(res.rounds[0].restarted_from is None and res.rounds[1].restarted_from is None,
          "no restore before round 3")
    check(0 < weight_bytes - L * 4 < 4096, "weight message is L*4 bytes plus framing")
    return {"launches": launches, "rounds": rounds, "wall_s": wall,
            "max_memory_allocated": peak, "weight_message_bytes": weight_bytes}


def phase_reference_check():
    """Reduced FEMNIST, 2 silos, 2 SGD-momentum rounds: the card (kernel)
    against the CPU (plain versions) from the same weights.  SGD keeps
    differences proportional to the ones in the gradients (cuDNN and the
    CPU sum convolutions in other orders), so 1e-4 holds them."""
    import torch
    from repro_torch.data import make_classification_silos
    from repro_torch.federated import FLServer
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves

    cfg = FemnistConfig(n_fc=2, fc_width=64)
    params0 = init_femnist_cnn(torch.Generator().manual_seed(3), cfg, "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        silos = make_classification_silos(2, 62, (28, 28, 1), [(64, 32)] * 2, seed=1)
        clients = _femnist_clients(cfg, silos, make_optimizer("sgdm", 0.01), device)
        res = FLServer(clients, params0, device=device).run(2)
        out[device] = res
    diff = max((a.cpu() - b).abs().max().item() for a, b in zip(
        tree_leaves(out["cuda"].final_params), tree_leaves(out["cpu"].final_params)))
    dloss = max(abs(a.metrics["loss"] - b.metrics["loss"])
                for a, b in zip(out["cuda"].rounds, out["cpu"].rounds))
    say(f"[reference] reduced FEMNIST, 2 rounds: max|param card - cpu|={diff:.3e}, "
        f"max|loss card - cpu|={dloss:.3e} (tol 1e-4)")
    check(diff < 1e-4 and dloss < 1e-4, "card run agrees with the CPU run")
    return {"max_param_diff": diff, "max_loss_diff": dloss}


def _server_trace(bus):
    """A bus trace with the wall-clock times of the server's lifecycle
    events taken out (fold events are on the round's virtual clock)."""
    import dataclasses

    out = []
    for e in bus.trace:
        d = dataclasses.asdict(e)
        if type(e).__name__ in ("RoundDispatched", "CheckpointSaved", "RecoveryCompleted"):
            d.pop("time_s")
        out.append((type(e).__name__, d))
    return out


def phase_compressed_path():
    """AsyncFLServer with int8 updates at the paper's FEMNIST width on the
    card: 4 silos, 2 rounds, message sizes measured, no checkpoints; then
    one fp16 round.  Every kernel's launch count is set to 0 just before
    each run and read just after."""
    import torch
    from repro_torch.data import make_classification_silos
    from repro_torch.federated import AsyncFLServer
    from repro_torch.federated.compression import compressed_wire_bytes, parse_compression
    from repro_torch.kernels.dequant_fold import dequant_fold
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves

    cfg = FemnistConfig()
    out = {}
    for codec, n_rounds, ratio in (("int8", 2, 4.0), ("fp16", 1, 2.0)):
        silos = make_classification_silos(N_SILOS, 62, (28, 28, 1), [(64, 32)] * N_SILOS, seed=0)
        clients = _femnist_clients(cfg, silos, make_optimizer("adamw", 1e-4), "cuda")
        params0 = init_femnist_cnn(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
        after_round = []
        server = AsyncFLServer(
            clients, params0, compression=codec, measure_round_messages=True,
            post_round_hook=lambda r, p: after_round.append(dequant_fold.launches),
            device="cuda")
        torch.cuda.reset_peak_memory_stats()
        dequant_fold.launches = 0
        fedavg_reduce.launches = 0
        t0 = time.monotonic()
        res = server.run(n_rounds)
        wall = time.monotonic() - t0
        launches = {"dequant_fold": dequant_fold.launches,
                    "fedavg_reduce": fedavg_reduce.launches}
        peak = torch.cuda.max_memory_allocated()
        want_bytes = compressed_wire_bytes(PAPER_L, parse_compression(codec))
        rounds = []
        for r in res.rounds:
            log = r.message_log
            rounds.append({"round": r.round_idx, "loss": r.metrics["loss"],
                           "acc": r.metrics["acc"], "agg_time_s": r.agg_time_s,
                           "train_time_s": r.train_time_s, "eval_time_s": r.eval_time_s,
                           "c_msg_train_bytes": log.c_msg_train_bytes,
                           "compression_ratio": log.compression_ratio})
            say(f"[compressed] {codec} round {r.round_idx}: loss={r.metrics['loss']:.4f} "
                f"acc={r.metrics['acc']:.4f} train_time_s={r.train_time_s:.3f} "
                f"(encode and fold included: agg_time_s={r.agg_time_s:.4f}) "
                f"eval_time_s={r.eval_time_s:.3f} c_msg_train {log.c_msg_train_bytes} B, "
                f"ratio {log.compression_ratio:.4f}")
        say(f"[compressed] {codec}: {n_rounds} rounds in {wall:.1f} s; dequant_fold launches "
            f"after each round {after_round}, fedavg_reduce launches "
            f"{launches['fedavg_reduce']}; max_memory_allocated {peak / 2**30:.2f} GiB")
        check(after_round == [N_SILOS * (i + 1) for i in range(n_rounds)],
              f"{N_SILOS} dequant_fold launches per {codec} round, got {after_round}")
        check(launches["fedavg_reduce"] == 0, "no fedavg_reduce launch on the compressed path")
        check(all(r["c_msg_train_bytes"] == want_bytes for r in rounds),
              f"c_msg_train is compressed_wire_bytes(L, {codec}) = {want_bytes} B")
        check(all(abs(r["compression_ratio"] - ratio) < 0.01 for r in rounds),
              f"{codec} compression ratio about {ratio}")
        check(all(math.isfinite(r["loss"]) for r in rounds), "finite losses")
        check(all(t.is_cuda for t in tree_leaves(res.final_params)), "every parameter on cuda")
        out[codec] = {"launches": launches, "launches_after_round": after_round,
                      "rounds": rounds, "wall_s": wall, "max_memory_allocated": peak,
                      "c_msg_train_bytes": want_bytes}
        del server, clients, res, params0
        torch.cuda.empty_cache()
    return out


def phase_compressed_reference_check():
    """Reduced FEMNIST, 3 silos, 3 int8 rounds with client_2 arriving after
    a fixed deadline every round (parked, materialized against its round's
    base, carried into the next round), the fold cost fixed so the virtual
    clock is exact: the card (kernels) against the CPU (plain versions)
    from the same weights.  Params within 1e-4 (SGD momentum at lr 1e-3;
    see phase_reference_check) and equal event traces."""
    import torch
    from repro_torch.data import make_classification_silos
    from repro_torch.federated import AsyncFLServer, DeterministicSchedule, FixedDeadline
    from repro_torch.kernels.dequant_fold import dequant_fold
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves

    cfg = FemnistConfig(n_fc=2, fc_width=64)
    params0 = init_femnist_cnn(torch.Generator().manual_seed(7), cfg, "cpu")
    delays = {"client_0": 1.0, "client_1": 1.5, "client_2": 6.0}
    runs = {}
    for device in ("cuda", "cpu"):
        silos = make_classification_silos(3, 62, (28, 28, 1), [(48, 16), (32, 16), (40, 32)],
                                          seed=2)
        clients = _femnist_clients(cfg, silos, make_optimizer("sgdm", 1e-3), device)
        server = AsyncFLServer(clients, params0, schedule=DeterministicSchedule(delays),
                               round_deadline=FixedDeadline(t_round_s=3.0), fold_cost_s=0.01,
                               compression="int8", device=device)
        before = dequant_fold.launches
        runs[device] = (server, server.run(3), dequant_fold.launches - before)
    (cserver, cres, claunch), (pserver, pres, plaunch) = runs["cuda"], runs["cpu"]
    diff = max((a.cpu() - b).abs().max().item()
               for a, b in zip(tree_leaves(cres.final_params), tree_leaves(pres.final_params)))
    dloss = max(abs(a.metrics["loss"] - b.metrics["loss"]) for a, b in zip(cres.rounds, pres.rounds))
    same_trace = _server_trace(cserver.bus) == _server_trace(pserver.bus)
    carried = [(r.carried_over, r.carried_in) for r in cres.rounds]
    say(f"[reference] reduced FEMNIST, 3 int8 rounds with carry-over: max|param card - cpu|="
        f"{diff:.3e}, max|loss card - cpu|={dloss:.3e} (tol 1e-4); event traces equal: "
        f"{same_trace}; (carried over, carried in) per round {carried}; dequant_fold "
        f"launches card {claunch}, cpu {plaunch}")
    check(diff < 1e-4 and dloss < 1e-4, "compressed card run agrees with the CPU run")
    check(same_trace, "compressed event traces equal")
    check(carried[0] == (["client_2"], []) and carried[1][1] == ["client_2"],
          "the slow silo is parked and carried in")
    check(claunch > 0 and plaunch == 0, "the card run launched the kernel, the CPU run did not")
    return {"max_param_diff": diff, "max_loss_diff": dloss, "traces_equal": same_trace,
            "carried": carried}


def main() -> int:
    import torch
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce  # noqa: F401 (fail early)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.monotonic()
    smi = phase_device()
    phase_build()
    main_err = phase_kernel_check()
    dq_err = phase_dequant_check()
    timing = phase_kernel_timing()
    dq_timing = phase_dequant_timing()
    fold = phase_fold_breakdown()
    compressed_split = phase_compressed_breakdown()
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_ckpt_") as d:
        path = phase_main_path(Path(d))
    compressed = phase_compressed_path()
    reference = phase_reference_check()
    compressed_reference = phase_compressed_reference_check()

    dq = dq_timing["int8"]
    kernels = [{
        "name": "fedavg_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:27",
        "launches": path["launches"],
        "max_abs_err": main_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }, {
        "name": "dequant_fold",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dequant_fold.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:70",
        "launches": compressed["int8"]["launches"]["dequant_fold"],
        "max_abs_err": dq_err,
        "ms": dq["ms"],
        "plain_ms": dq["plain_ms"],
        "bound_ms": dq["bound_ms"],
        "bound_by": dq["bound_by"],
        "library_ms": dq["library_ms"],
    }]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "nvidia_smi": smi, "kernels": kernels, "timing": timing, "fold": fold, "path": path,
        "reference": reference, "dequant_timing": dq_timing,
        "compressed_breakdown": compressed_split, "compressed_path": compressed,
        "compressed_reference": compressed_reference, "seconds": time.monotonic() - t_start,
    }, indent=1))
    say(f"[done] {time.monotonic() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
