#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX
or of the JAX package.  In order it:

  1. prints the card (``nvidia-smi`` name and power limit) and turns TF32
     off for matmuls and cuDNN convolutions;
  2. builds every kernel of the port's paths from ``src/repro_torch/
     kernels/csrc`` with nvcc (one process per source, all started
     together), prints ptxas's registers and shared memory per kernel and,
     where ``cuobjdump`` is found, the count of wgmma (HGMMA), TMA load
     (UTMALDG) and mma.sync (HMMA) instructions in each library's SASS;
  3. holds each kernel against its plain PyTorch version on the card, over
     the CPU tests' sweeps and at the paths' shapes (``dequant_fold`` bit
     for bit, on aligned and misaligned payloads; ``flash_attention`` over
     MHA / GQA / MQA at both head widths, windows inside and across tiles,
     full attention, ragged S, fp32 and bf16, and olmo-1b's prefill;
     ``ssd_chunk_scan`` over the reference's sweep, head counts and chunks
     off the kernel's tiles, the state continuation, the O(L) recurrence and
     mamba2-130m's prefill);
  4. times each kernel at its path's shape (CUDA events around each
     launch after warm-up; 4 rounds of 10 launches each of kernel, plain
     version and one PyTorch library call computing the same function,
     where there is one, in alternating order; median and quartiles)
     beside its bound, with the card's clocks and power after; splits the
     dense fold at that shape into flatten, reduce and unflatten, and the
     compressed round's server work into encode, wire frame and fold;
  5. runs the dense main path at the paper's FEMNIST width
     (``FemnistConfig()``, L = 164,187,070 parameters): 4 silos, 3 FedAvg
     rounds, client and server checkpoints, the server killed at round 3
     and restored from stable storage, message sizes measured;
  6. runs the compressed path at the same width: ``AsyncFLServer`` with
     int8 updates, 4 silos, 2 rounds, then one fp16 round, message sizes
     measured;
  7. runs a reduced FEMNIST model on the card and on the CPU (plain
     versions) from the same weights and compares them: 2 dense rounds,
     and 3 int8 rounds with a slow silo parked past a deadline and
     carried into the next round;
  8. serves olmo-1b and mamba2-130m at full width (bf16, random weights):
     ``prefill_step`` on a (4, 2048) batch (16 ``flash_attention`` and 24
     ``ssd_chunk_scan`` launches exactly), timed 5 times and traced once
     with ``torch.profiler`` (the device's busy time, idle share and
     heaviest kernels), the serve driver (a (4, 32) and
     a (4, 256) prompt token by token, 16 tokens decoded, no kernel
     launch), and the prompt's prefill logits against its token-by-token
     logits, in bf16 and again in fp32;
  9. runs reduced olmo-1b and mamba2-130m in fp32 on the card and on the
     CPU from the same weights: prefill logits and greedy tokens;
 10. trains olmo-1b at full width (bf16, (2, 2048) batches): the flash
     backward kernel held against its plain version over the forward's
     cases (phase 3) and timed against SDPA's gradient (phase 4, with the
     forward with and without its log-sum-exp store), five timed
     ``make_train_step`` steps and one traced, each with 16 forward and 16
     backward launches, and ``repro_torch.launch.train.main`` for 8 steps
     (exit 0: the loss fell);
 11. runs federated LoRA on olmo-1b at full width (``with_lora(2)``, 4
     silos): 2 rounds uncompressed and 2 with int8 adapter deltas under
     ``AsyncFLServer(schema=lora_adapter_schema())``, the base bit-equal
     and the adapters moved after every round, per-group wire bytes as
     ``measure_messages`` counts them, ``dequant_fold`` once a silo in an
     int8 round;
 12. runs reduced olmo-1b in fp32 on the card and on the CPU from the
     same weights: one train step, and one federated LoRA round of 2
     silos (adapters within 1e-4, base bit-equal, traces equal).
For each path every kernel's launch count is set to 0 just before and
read just after.

Any failed check exits non-zero.  The line before the last is the
``{"kernels": [...]}`` record; the last is ``{"ok": true, "device": ...}``.
Details also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import re
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
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
PAPER_L = 164_187_070       # FemnistConfig() parameter count
N_SILOS = 4
TIMING_ROUNDS = 4       # rounds of kernel / plain / library, order alternating
TIMED_PER_ROUND = 10    # launches of each per round: 40 samples each
PREFILL_RUNS = 5        # timed full-width prefills a model, after one warm-up
PREFILL_B, PREFILL_S = 4, 2048   # the zoo's full-width prefill batch
KERNELS = ("fedavg_reduce", "dequant_fold", "flash_attention", "flash_attention_bwd",
           "ssd_chunk_scan")
TRAIN_B, TRAIN_S = 2, 2048      # the zoo's full-width training batch
TRAIN_STEPS = 5                 # timed train steps, after one warm-up
LORA_SILOS = 4


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


def alternating(fns: dict) -> tuple:
    """Quartiles (ms) of each of ``fns`` over TIMING_ROUNDS rounds of
    TIMED_PER_ROUND launches, in alternating order, after 5 warm-up calls
    of each; also the sample count."""
    for fn in fns.values():
        for _ in range(5):
            fn()
    samples = {k: [] for k in fns}
    for r in range(TIMING_ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            samples[k] += cuda_times(fns[k], TIMED_PER_ROUND)
    return {k: quartiles(v) for k, v in samples.items()}, len(samples[next(iter(fns))])


def _wrappers() -> dict:
    from repro_torch.kernels.dequant_fold import dequant_fold
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan

    return {"fedavg_reduce": fedavg_reduce, "dequant_fold": dequant_fold,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "ssd_chunk_scan": ssd_chunk_scan}


def zero_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for fn in _wrappers().values():
        fn.launches = 0


def counts() -> dict:
    """Every kernel's launch count, read just after a path is driven."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in fp32."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


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
    libs = _build.build(["fedavg_reduce", "dequant_fold", "flash_attention",
                         "flash_attention_bwd", "ssd_scan"])
    say(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} "
        f"in {time.monotonic() - t0:.1f} s")
    ptxas = []
    for name in libs:
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                ptxas.append(f"{name}: {line.strip()}")
                say(f"[build] {ptxas[-1]}")
    return sass_counts(libs), ptxas


def sass_counts(libs: dict) -> dict:
    """Counts of tensor-core and TMA instructions in the built libraries'
    SASS (``cuobjdump -sass``), where ``cuobjdump`` is found: the bf16
    flash kernel must issue wgmma (HGMMA) and TMA loads (UTMALDG), the scan
    its bf16 scores on mma.sync (HMMA)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        say("[build] cuobjdump not found: no SASS counts (ptxas' report above stands)")
        return {}
    out = {}
    for name, lib in libs.items():
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        out[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "HMMA")}
        say(f"[build] {name} SASS: " + ", ".join(f"{op} {n}" for op, n in out[name].items()))
    check(out["flash_attention"]["HGMMA"] > 0 and out["flash_attention"]["UTMALDG"] > 0,
          "the flash library issues wgmma and TMA loads")
    check(out["ssd_scan"]["HMMA"] > 0, "the scan library forms bf16 scores on the tensor cores")
    check(out["flash_attention_bwd"]["HMMA"] > 0,
          "the flash backward library runs its bf16 products on the tensor cores")
    return out


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
    q, n_samples = alternating(fns)
    state = card_state()
    ms, plain_ms, library_ms = q["kernel"][1], q["plain"][1], q["library"][1]
    nbytes = (n * L + L) * 4 + n * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2 * n * L / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    for k, name in (("kernel", "fedavg_reduce kernel"), ("plain", "plain version"),
                    ("library", "torch.matmul")):
        say(f"[time] {name} N={n} L={L} fp32: median {q[k][1]:.4f} ms, "
            f"quartiles {q[k][0]:.4f}-{q[k][2]:.4f} ms over {n_samples} launches")
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
        q, n_samples = alternating(fns)
        state = card_state()
        itemsize = data.element_size()
        nbytes = n * (4 + 4 + itemsize) + nb * 4
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = 2 * n / FP32_FLOPS_PER_S * 1e3
        ms = q["kernel"][1]
        for k, name in (("kernel", "dequant_fold kernel"), ("plain", "plain version"),
                        ("library", "addcmul_")):
            say(f"[time] {name} {codec} n={n} into Lp={lp}: median {q[k][1]:.4f} ms, "
                f"quartiles {q[k][0]:.4f}-{q[k][2]:.4f} ms over {n_samples} launches")
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
    zero_counts()
    t0 = time.monotonic()
    res = server.run(3)
    wall = time.monotonic() - t0
    after = counts()
    launches = after["fedavg_reduce"]
    check(after == dict.fromkeys(KERNELS, 0) | {"fedavg_reduce": launches},
          f"only fedavg_reduce launches on the dense path, got {after}")

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
        zero_counts()
        t0 = time.monotonic()
        res = server.run(n_rounds)
        wall = time.monotonic() - t0
        launches = counts()
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
        check(launches == dict.fromkeys(KERNELS, 0) | {"dequant_fold": N_SILOS * n_rounds},
              f"only dequant_fold launches on the compressed path, got {launches}")
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


# ---------------------------------------------------------------------------
# The model zoo's serve path: flash_attention and ssd_chunk_scan
# ---------------------------------------------------------------------------

def _qkv(B, S, H, KV, D, dtype, gen):
    import torch

    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))


def phase_flash_check():
    """flash_attention against its plain version (``causal_attention`` /
    ``full_attention``) on the card: MHA, GQA 4:1 and MQA at head widths 64
    and 128, windows 16, 64 and 100 (inside a 128-key tile) and 200 and 300
    (across tiles), full attention, ragged S (40, 100, 130, 300, 1000: below
    64 and past multiples of 64 and 128), fp32 (2e-5) and bf16
    (2e-2; the plain version rounds the softmax weights to bf16, the
    kernel keeps them in fp32), and olmo-1b's prefill (B 4, S 2048, 16
    heads of 128, bf16, causal), the main path's call, whose error is
    returned.

    A bf16 output is also held, as a whole, against the plain version
    computed in fp32 from the same bf16 inputs: relative L2 within 1e-2.
    The kernel's bf16 rounding of the probabilities and of the output
    alone gives a few 1e-3; the elementwise 2e-2 is loose where |o| is
    small (a long causal row of N(0, 1) inputs averages to |o| ~ 0.05),
    and this catches a fault that shifts many rows by less than that."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [(2, 256, 4, 4, 64, True, None, dt), (2, 256, 8, 2, 64, True, None, dt),
                  (2, 256, 4, 1, 128, True, None, dt)]
        cases += [(1, 256, 4, 2, 64, True, w, dt) for w in (16, 64, 100)]
        cases += [(2, 128, 4, 4, 64, False, None, dt), (2, 100, 4, 2, 128, True, None, dt),
                  (2, 300, 4, 2, 128, True, None, dt), (1, 300, 4, 4, 64, False, None, dt)]
        # The bf16 kernel's tile edges (128 query rows, 128-key tiles): S
        # past a multiple of 128 and below 64, a window spanning tiles, GQA
        # 4:1 and MQA at both head widths.
        cases += [(1, 130, 4, 2, 128, True, None, dt), (1, 1000, 4, 1, 64, True, None, dt),
                  (2, 40, 4, 4, 64, True, None, dt), (1, 130, 4, 4, 128, False, None, dt),
                  (1, 1000, 8, 2, 128, True, 200, dt), (1, 512, 4, 4, 64, True, 300, dt),
                  (1, 256, 8, 2, 128, True, None, dt), (1, 256, 4, 1, 64, True, None, dt)]
    main_case = (PREFILL_B, PREFILL_S, 16, 16, 128, True, None, torch.bfloat16)
    cases.append(main_case)
    main_err = None
    for case in cases:
        B, S, H, KV, D, causal, window, dt = case
        q, k, v = _qkv(B, S, H, KV, D, dt, gen)
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = 2e-2 if dt == torch.bfloat16 else 2e-5
        err = (got.float() - want.float()).abs().max().item()
        ok = got.dtype == dt and bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=tol, rtol=tol)
        l2 = ""
        if dt == torch.bfloat16:
            del want
            want = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                         window=window)
            rel = rel_l2(got, want)
            ok = ok and rel <= 1e-2
            l2 = f", relative L2 against fp32 plain {rel:.3e} (tol 1e-2)"
        say(f"[check] flash_attention B={B} S={S} H={H} KV={KV} D={D} "
            f"{'causal' if causal else 'full'} window={window} {str(dt)[6:]}: "
            f"max|kernel-plain|={err:.3e} (tol {tol:g} abs+rel){l2} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention {case} within {tol}")
        if case == main_case:
            main_err = err
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return main_err


def _ssd_inputs(B, L, H, P, N, dtype, gen):
    """The reference tests' distribution: x, B, C ~ N(0, 1), dt =
    softplus(N(0, 1)), A = -exp(N(0, 1)); dt and A fp32."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return (randn(B, L, H, P).to(dtype), F.softplus(randn(B, L, H)), -torch.exp(randn(H)),
            randn(B, L, N).to(dtype), randn(B, L, N).to(dtype))


def _scaled_close(got, want, tol: float):
    """allclose with the absolute part taken relative to the output's scale
    (``tol * max(1, max|want|)``): the scan sums chunk-long runs of products
    as large as its outputs, so another summation order leaves absolute
    errors in proportion to the largest terms, also where an element
    cancels to near 0."""
    import torch

    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=tol * scale, rtol=tol)
    return ok, err


def phase_ssd_check():
    """ssd_chunk_scan against its plain version on the card: the reference
    tests' sweep (tests/test_kernels.py:99-150, fp32, 2e-5 scaled), the
    initial-state continuation and the O(L) recurrence ``ssd_reference``
    (1e-3, as there), and mamba2-130m's prefill (B 4, L 2048, 24 heads of
    P 64, N 128, chunk 256) in fp32 and in bf16 (the main path's call; y
    comes back in bf16, 2e-2, and as a whole within 1e-2 relative L2 of
    the plain version computed in fp32 from the same bf16 inputs: the
    output's rounding alone gives ~1e-3), and the kernel's edges (H not a
    multiple of its head group of 4, chunks of 96, 150 and 160 positions).
    At that shape and at the edges the kernel's three outputs are also held
    against its plain version alone (2e-5 scaled); the largest error of
    those at mamba2-130m's shape in bf16 is returned."""
    import torch
    from repro_torch.kernels.ssd_scan import (
        ssd_chunk_scan, ssd_chunk_scan_plain, ssd_intra_chunk, ssd_intra_chunk_plain)
    from repro_torch.models.mamba2 import ssd_reference

    gen = torch.Generator(device="cuda").manual_seed(9)
    full = (PREFILL_B, PREFILL_S, 24, 64, 128, 256)
    cases = [((2, 64, 4, 16, 32, 16), torch.float32), ((2, 128, 8, 32, 64, 32), torch.float32),
             ((2, 256, 8, 64, 128, 64), torch.float32), ((2, 200, 4, 32, 16, 100), torch.float32),
             (full, torch.float32), (full, torch.bfloat16)]
    # The kernel's edges: H not a multiple of its head group (4) and a chunk
    # not a multiple of its 64-position tiles, in both dtypes.
    edges = [((1, 192, 6, 64, 128, 96), torch.float32), ((1, 192, 6, 64, 128, 96), torch.bfloat16),
             ((2, 300, 5, 16, 36, 150), torch.bfloat16), ((1, 320, 7, 32, 64, 160), torch.float32)]
    cases += edges
    main_err = None
    for (B, L, H, P, N, Q), dt in cases:
        args = _ssd_inputs(B, L, H, P, N, dt, gen)
        y, h = ssd_chunk_scan(*args, chunk=Q)
        torch.cuda.synchronize()
        y_want, h_want = ssd_chunk_scan_plain(*args, Q)
        tol = 2e-2 if dt == torch.bfloat16 else 2e-5
        ok_y, err_y = _scaled_close(y, y_want, tol)
        ok_h, err_h = _scaled_close(h, h_want, 2e-5)
        l2 = ""
        if dt == torch.bfloat16:
            del y_want
            y_want, _ = ssd_chunk_scan_plain(*(t.float() for t in args), Q)
            rel = rel_l2(y, y_want)
            ok_y = ok_y and rel <= 1e-2
            l2 = f", y relative L2 against fp32 plain {rel:.3e} (tol 1e-2)"
        say(f"[check] ssd_chunk_scan B={B} L={L} H={H} P={P} N={N} chunk={Q} {str(dt)[6:]}: "
            f"max|kernel-plain| y {err_y:.3e} (tol {tol:g} scaled), state {err_h:.3e} "
            f"(tol 2e-05 scaled){l2} {'ok' if ok_y and ok_h else 'FAIL'}")
        check(ok_y and ok_h and y.dtype == dt, f"ssd_chunk_scan {(B, L, H, P, N, Q, dt)}")
        if (B, L, H, P, N, Q) == full or ((B, L, H, P, N, Q), dt) in edges:
            errs = []
            for name, g, w in zip(("y_diag", "states", "a_cs"), ssd_intra_chunk(*args, Q),
                                  ssd_intra_chunk_plain(*args, Q)):
                ok, err = _scaled_close(g, w, 2e-5)
                errs.append(err)
                say(f"[check]   kernel alone, {name}: max|kernel-plain|={err:.3e} "
                    f"(tol 2e-05 scaled) {'ok' if ok else 'FAIL'}")
                check(ok, f"ssd_intra_chunk {name} at {(B, L, H, P, N, Q)} {dt}")
            if (B, L, H, P, N, Q) == full and dt == torch.bfloat16:
                main_err = max(errs)
        del args, y, h, y_want, h_want

    x, dt_, A, Bm, Cm = _ssd_inputs(1, 128, 4, 8, 16, torch.float32, gen)
    y_full, h_full = ssd_chunk_scan(x, dt_, A, Bm, Cm, chunk=32)
    _, h1 = ssd_chunk_scan(x[:, :64], dt_[:, :64], A, Bm[:, :64], Cm[:, :64], chunk=32)
    y2, h2 = ssd_chunk_scan(x[:, 64:], dt_[:, 64:], A, Bm[:, 64:], Cm[:, 64:], chunk=32,
                            initial_state=h1)
    y_seq, h_seq = ssd_reference(x, dt_, A, Bm, Cm)
    results = {"continuation y": _scaled_close(y2, y_full[:, 64:], 1e-3),
               "continuation state": _scaled_close(h2, h_full, 1e-3),
               "O(L) recurrence y": _scaled_close(y_full, y_seq, 1e-3),
               "O(L) recurrence state": _scaled_close(h_full, h_seq, 1e-3)}
    for name, (ok, err) in results.items():
        say(f"[check] ssd_chunk_scan {name}: max|diff|={err:.3e} (tol 1e-3 scaled) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"ssd_chunk_scan {name}")
    torch.cuda.empty_cache()
    return main_err


def phase_zoo_timing():
    """Both kernels at the full-width prefill shapes: kernel, plain version
    and (flash only) ``F.scaled_dot_product_attention`` in alternating
    rounds, beside their bounds.

    flash_attention, olmo-1b: q, k, v (4, 2048, 16, 128) bf16, causal.  The
    products take 2·B·H·D·S·(S+1) flops (each query row meets its i + 1
    keys in two products of 2·D), on the bf16 tensor cores' 989 TFLOP/s;
    the bytes are q, k, v and o read or written once.

    ssd_chunk_scan, mamba2-130m: the kernel alone (the intra-chunk part) on
    x (4, 2048, 24, 64), B, C (4, 2048, 128) in bf16, dt fp32, chunk 256.
    Its arithmetic is the reference's, in fp32, counted where the decay
    is not zero (s <= l, as the flash count is causal): y Q·(Q+1)·P and
    the state 2·P·N·Q per (b, chunk, head), the scores Q·(Q+1)·N per
    (b, chunk), at 67 TFLOP/s; the bytes are x, B, C, dt read once and
    y, the states and a_cs (fp32) written once.  No single PyTorch call
    computes it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.ssd_scan import (
        ssd_chunk_scan, ssd_chunk_scan_plain, ssd_intra_chunk, ssd_intra_chunk_plain)

    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {}

    B, S, H, D = PREFILL_B, PREFILL_S, 16, 128
    q, k, v = _qkv(B, S, H, H, D, torch.bfloat16, gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    q4, n = alternating({
        "kernel": lambda: flash_attention(q, k, v),
        "plain": lambda: flash_attention_plain(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
    })
    flops = 2 * B * H * D * S * (S + 1)
    nbytes = 4 * B * S * H * D * 2
    out["flash_attention"] = _bound_row(q4, n, flops, BF16_FLOPS_PER_S, nbytes,
                                        "flash_attention olmo-1b prefill (4, 2048, 16, 128) bf16",
                                        "F.scaled_dot_product_attention(is_causal=True)")
    del q, k, v, qt, kt, vt

    B, L, H, P, N, Q = PREFILL_B, PREFILL_S, 24, 64, 128, 256
    args = _ssd_inputs(B, L, H, P, N, torch.bfloat16, gen)
    q4, n = alternating({
        "kernel": lambda: ssd_intra_chunk(*args, Q),
        "plain": lambda: ssd_intra_chunk_plain(*args, Q),
    })
    C = L // Q
    flops = B * C * H * (Q * (Q + 1) * P + 2 * P * N * Q) + B * C * Q * (Q + 1) * N
    nbytes = (B * L * H * P * 2 + 2 * B * L * N * 2 + B * L * H * 4
              + B * C * H * (Q * P + P * N + Q) * 4)
    row = _bound_row(q4, n, flops, FP32_FLOPS_PER_S, nbytes,
                     "ssd_chunk_scan kernel alone, mamba2-130m prefill (4, 2048, 24, 64), N 128, "
                     "chunk 256, bf16", None)
    scan, _ = alternating({"kernel": lambda: ssd_chunk_scan(*args, chunk=Q),
                           "plain": lambda: ssd_chunk_scan_plain(*args, Q)})
    row["whole_scan_ms"], row["whole_scan_plain_ms"] = scan["kernel"][1], scan["plain"][1]
    say(f"[time] the whole scan (kernel + inter-chunk torch ops) {scan['kernel'][1]:.4f} ms, "
        f"plain ssd_chunked {scan['plain'][1]:.4f} ms")
    out["ssd_chunk_scan"] = row
    del args
    torch.cuda.empty_cache()
    return out


def _bound_row(q4: dict, n: int, flops: float, peak: float, nbytes: float, what: str,
               library: "str | None") -> dict:
    state = card_state()
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    ms = q4["kernel"][1]
    names = (("kernel", "kernel"), ("plain", "plain version")) + (
        (("library", library),) if library else ())
    for k, name in names:
        say(f"[time] {what}: {name} median {q4[k][1]:.4f} ms, quartiles "
            f"{q4[k][0]:.4f}-{q4[k][2]:.4f} ms over {n} launches")
    say(f"[time] bound {bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s "
        f"= {ops_ms:.4f} ms; {nbytes / 1e6:.1f} MB at 3.35 TB/s = {bytes_ms:.4f} ms); kernel "
        f"{flops / ms / 1e9:.1f} TFLOP/s = {bound_ms / ms:.1%} of the bound; card after timing: "
        f"{state}")
    return {"ms": ms, "plain_ms": q4["plain"][1],
            "library_ms": q4["library"][1] if library else None,
            "quartiles_ms": q4, "card_state": state, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": nbytes, "achieved_tflop_s": flops / ms / 1e9}


def _trace_prefill(run, tag: str, what: str = "prefill") -> dict:
    """One more prefill (or other step) under ``torch.profiler`` (CPU and CUDA activity):
    the device's busy time (the union of its kernels' intervals) against
    the host clock around the call, so the device's idle share, and the
    kernels that take the most device time.  The profiler's own cost on the
    host is in the wall time; the timed prefills above are not traced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        say(f"{tag}: traced {what}: the profiler recorded no device time "
            f"(wall {wall * 1e3:.1f} ms)")
        return {"wall_s": wall, "device_busy_s": None}
    busy, end = 0.0, -math.inf
    by_name: dict = {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[e.name] = by_name.get(e.name, 0.0) + (stop - start)
    busy_s = busy * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    say(f"{tag}: traced {what}: wall {wall * 1e3:.1f} ms, device busy {busy_s * 1e3:.1f} ms "
        f"({len(kernels)} kernels), idle share {1 - busy_s / wall:.1%}; most device time: "
        + "; ".join(f"{name[:60]} {t / 1e3:.2f} ms" for name, t in top))
    return {"wall_s": wall, "device_busy_s": busy_s, "n_kernels": len(kernels),
            "top_kernels_ms": [(name, t / 1e3) for name, t in top]}


def _serve_check(arch: str, dtype: str, prompt_len: int, decode_tokens: int, kernel: str,
                 per_prefill: int, tol: float, full_prefill: bool) -> dict:
    """One zoo model at full width on the card, weights random from seed 0:
    ``prefill_step`` on a (4, 2048) batch, PREFILL_RUNS times after a
    warm-up (``full_prefill``; median and quartiles) and once more under
    the profiler (device busy time and idle share), then the serve
    driver (token-by-token prefill of a (4, prompt_len) prompt through
    ``serve_step``, then greedy decoding), then ``prefill_step`` on that
    prompt, whose logits must agree with the token-by-token ones at every
    prompt position within ``tol`` (relative L2 over the whole tensor).
    Every kernel's count is set to 0 just before each run and read just
    after: ``kernel`` launches ``per_prefill`` times a prefill and never
    in decode."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_model

    cfg = get_config(arch).with_overrides(dtype=dtype, param_dtype=dtype)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = model.param_count(params)
    prefill = make_prefill_step(model)
    only = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(0)
    out = {"arch": arch, "dtype": dtype, "params": n_params}
    tag = f"[zoo] {arch} {dtype}"

    if full_prefill:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).cuda()
        prefill(params, {"tokens": tokens})  # warm-up: cuBLAS and the kernels' first load
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, all_launches = [], []
        for _ in range(PREFILL_RUNS):
            logits = None
            zero_counts()
            t0 = time.monotonic()
            logits = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            all_launches.append(counts())
        launches = all_launches[-1]
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        q1, med, q3 = quartiles(times)
        say(f"{tag}: {n_params:,} params; prefill_step on ({PREFILL_B}, {PREFILL_S}) median "
            f"{med * 1e3:.1f} ms, quartiles {q1 * 1e3:.1f}-{q3 * 1e3:.1f} ms over {PREFILL_RUNS} "
            f"runs (each {', '.join(f'{t * 1e3:.1f}' for t in times)}), logits "
            f"{tuple(logits.shape)} {str(logits.dtype)[6:]} finite={finite}; launches a run "
            f"{launches}; max_memory_allocated {peak / 2**30:.2f} GiB")
        check(tuple(logits.shape) == (PREFILL_B, PREFILL_S, cfg.vocab_size)
              and logits.dtype == torch.float32 and finite, f"{arch} prefill logits")
        check(all(n == only | {kernel: per_prefill} for n in all_launches),
              f"{arch} prefill: exactly {per_prefill} {kernel} launches a run, got {all_launches}")
        out.update(prefill_s=med, prefill_s_quartiles=(q1, med, q3), prefill_s_runs=times,
                   prefill_launches=launches, prefill_peak_bytes=peak)
        zero_counts()
        out["prefill_trace"] = _trace_prefill(lambda: prefill(params, {"tokens": tokens}), tag)
        check(counts() == only | {kernel: per_prefill}, f"{arch} traced prefill launches")
        del logits, tokens

    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (PREFILL_B, prompt_len))).cuda()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = generate(model, params, prompt, decode_tokens, keep_prompt_logits=True)
    serve_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    ms_tok = res.decode_s / max(decode_tokens - 1, 1) * 1e3
    say(f"{tag}: serve driver, ({PREFILL_B}, {prompt_len}) prompt token by token in "
        f"{res.prefill_s:.3f} s, {decode_tokens} tokens decoded at {ms_tok:.2f} ms/token; "
        f"launches {serve_launches}; first sequence {res.tokens[0].tolist()}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(serve_launches == only, f"{arch} serve: no kernel launch, got {serve_launches}")
    check(tuple(res.tokens.shape) == (PREFILL_B, decode_tokens)
          and bool(torch.isfinite(res.last_logits).all()), f"{arch} serve output")

    zero_counts()
    logits = prefill(params, {"tokens": prompt})
    launches = counts()
    err = rel_l2(logits, res.prompt_logits)
    max_abs = (logits - res.prompt_logits).abs().max().item()
    agree = (logits.argmax(-1) == res.prompt_logits.argmax(-1)).float().mean().item()
    say(f"{tag}: prefill_step on that prompt vs its token-by-token logits: relative L2 "
        f"{err:.3e} (tol {tol:g}), max|diff| {max_abs:.3e} (max|logit| "
        f"{logits.abs().max().item():.3f}), argmax agreement {agree:.4f}; launches {launches}")
    check(launches == only | {kernel: per_prefill}, f"{arch} prompt prefill launches")
    check(err <= tol, f"{arch} {dtype} prefill agrees with token-by-token serving within {tol}")
    out.update(serve_prefill_s=res.prefill_s, decode_ms_per_token=ms_tok,
               serve_launches=serve_launches, prompt_prefill_launches=launches,
               serve_peak_bytes=peak,
               prefill_vs_serve_rel_l2=err, prefill_vs_serve_max_abs=max_abs,
               argmax_agreement=agree, tokens_first_sequence=res.tokens[0].tolist())
    del params, logits, res
    torch.cuda.empty_cache()
    return out


def phase_zoo_paths():
    """The serve path at full width, olmo-1b then mamba2-130m: in bf16 (the
    configs' dtype) with the 2048-token prefill and the serve driver, then
    the prefill-against-serving check again in fp32.

    Tolerances of prefill against token-by-token serving (relative L2 over
    all logits): fp32 1e-3, about 20x what plain prefill against plain
    decode reads on the CPU through 24 layers of a reduced mamba2
    (6e-5): the two paths are the same arithmetic in another order.  In
    bf16 the paths round differently (the kernel keeps its softmax
    weights and the scan its products in fp32, the decode path rounds to
    bf16 at other places), and a random network carries those roundings
    through every layer.  On the CPU at full width, olmo-1b with the
    kernel's rounding imitated in the prefill reads 1.66e-2, so 5e-2;
    mamba2-130m's plain prefill against its plain decode reads 0.197, so
    0.5 there, which catches only gross faults (the fp32 check holds the
    scan tightly)."""
    out = {}
    out["olmo-1b bf16"] = _serve_check("olmo-1b", "bfloat16", 32, 16, "flash_attention", 16,
                                       5e-2, True)
    out["mamba2-130m bf16"] = _serve_check("mamba2-130m", "bfloat16", 256, 16, "ssd_chunk_scan",
                                           24, 0.5, True)
    out["olmo-1b fp32"] = _serve_check("olmo-1b", "float32", 32, 2, "flash_attention", 16,
                                       1e-3, False)
    out["mamba2-130m fp32"] = _serve_check("mamba2-130m", "float32", 256, 2, "ssd_chunk_scan",
                                           24, 1e-3, False)
    return out


def phase_zoo_reference_check():
    """Reduced olmo-1b and mamba2-130m in fp32 from the same weights on the
    card (kernels) and on the CPU (plain versions): prefill logits on a
    (2, 64) batch within 1e-4 (abs and rel; fp32 summed in other orders,
    the CPU parity tests' tolerance) and the serve driver's greedy tokens
    equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_map

    out = {}
    for arch, kernel in (("olmo-1b", "flash_attention"), ("mamba2-130m", "ssd_chunk_scan")):
        cfg = get_config(arch).reduced().with_overrides(dtype="float32", param_dtype="float32")
        model = get_model(cfg)
        params = model.init(torch.Generator().manual_seed(3), "cpu")
        rng = np.random.default_rng(4)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
        runs = {}
        for device in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(device), params)
            zero_counts()
            logits = make_prefill_step(model)(p, {"tokens": tokens.to(device)})
            toks = generate(model, p, prompt.to(device), 6).tokens
            runs[device] = (logits.cpu(), toks.cpu(), counts()[kernel])
        (cl, ct, cn), (pl, pt, pn) = runs["cuda"], runs["cpu"]
        err = (cl - pl).abs().max().item()
        ok = torch.allclose(cl, pl, atol=1e-4, rtol=1e-4)
        same = torch.equal(ct, pt)
        say(f"[reference] reduced {arch} fp32, card against CPU: max|logits diff| {err:.3e} "
            f"(tol 1e-4 abs+rel) {'ok' if ok else 'FAIL'}; greedy tokens equal: {same}; "
            f"{kernel} launches card {cn}, cpu {pn}")
        check(ok and same, f"reduced {arch}: card agrees with the CPU")
        check(cn == cfg.n_layers and pn == 0, f"{arch}: the card run launched the kernel once a "
              f"layer, the CPU run not at all")
        out[arch] = {"max_logits_diff": err, "tokens_equal": same}
    return out


# ---------------------------------------------------------------------------
# Training the zoo and federated LoRA: flash_attention_bwd
# ---------------------------------------------------------------------------

def _flash_module():
    """The flash wrapper module (the package re-exports its function under
    the module's name, so ``import ... as`` would give the function)."""
    import repro_torch.kernels.flash_attention  # noqa: F401

    return sys.modules["repro_torch.kernels.flash_attention"]


def phase_flash_bwd_check():
    """The backward kernel against ``flash_attention_bwd_plain`` computed in
    fp32 from the same inputs (the forward kernel's output and log-sum-exp,
    the same dO): olmo-1b's shape (4, 2048, 16, 128) causal bf16 (the main
    path's call), GQA (32 query heads on 8), D 64, a window across tiles,
    full attention, ragged S (1000, 130 and 1), the fp32 path, and a q
    whose base is off 16 bytes.  bf16: relative L2 <= 1e-2 per gradient;
    fp32: within 2e-5 of each gradient's max |.|.  At S = 1, dq and dk are
    0 in exact arithmetic (one key: P = 1 and dP = Delta), so they are held
    within 1e-2 (bf16) / 2e-5 (fp32) of max|dv| instead.  The forward's
    log-sum-exp is held against ``attention_lse_plain`` within 2e-5 of its
    scale, and the forward's output with the log-sum-exp stored must equal
    the output without it bit for bit.  Returns the largest |kernel - plain|
    over the three gradients at olmo-1b's shape."""
    import torch

    fa = _flash_module()
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    main_case = (PREFILL_B, PREFILL_S, 16, 16, 128, True, None, bf)
    cases = [main_case,
             (2, 1024, 32, 8, 128, True, None, bf),     # GQA 4:1
             (2, 512, 8, 8, 64, True, None, bf),        # D 64
             (1, 1000, 8, 2, 128, True, 200, bf),       # a window across tiles
             (2, 300, 4, 4, 128, False, None, bf),      # full attention, ragged S
             (1, 1000, 4, 1, 64, True, None, bf),       # ragged S, MQA
             (2, 130, 4, 2, 128, True, None, bf),
             (1, 1, 4, 2, 128, True, None, bf),         # one position
             (2, 300, 8, 2, 64, True, None, f32),       # the fp32 path
             (1, 1000, 4, 2, 128, True, 100, f32),
             (2, 130, 4, 4, 128, False, None, f32),
             (1, 1, 4, 4, 64, True, None, f32)]
    main_err = None
    for case in cases:
        B, S, H, KV, D, causal, window, dt = case
        q, k, v = _qkv(B, S, H, KV, D, dt, gen)
        dout = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        o = fa._launch(q, k, v, causal, window, lse=lse)
        o_plain_fwd = fa._launch(q, k, v, causal, window)
        got = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal, window=window)
        torch.cuda.synchronize()
        lse_want = fa.attention_lse_plain(q.float(), k.float(), causal, window)
        lse_err = (lse - lse_want).abs().max().item()
        ok = torch.equal(o, o_plain_fwd) and lse_err <= 2e-5 * max(1.0, lse_want.abs().max().item())
        want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            dout.float(), causal, window)
        tol = 1e-2 if dt == bf else 2e-5
        errs, scores = [], []
        dv_scale = want[2].abs().max().item()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            ok = ok and g.dtype == dt and g.shape == w.shape and bool(torch.isfinite(g).all())
            err = (g.float() - w).abs().max().item()
            errs.append(err)
            if S == 1 and name != "dv":
                score = err / dv_scale
            elif dt == bf:
                score = rel_l2(g, w)
            else:
                score = err / max(1.0, w.abs().max().item())
            scores.append(score)
            ok = ok and score <= tol
        measure = ("max|.|/max|dv|" if S == 1 else
                   "relative L2" if dt == bf else "max|kernel-plain|/max(1,max|plain|)")
        say(f"[check] flash_attention_bwd B={B} S={S} H={H} KV={KV} D={D} "
            f"{'causal' if causal else 'full'} window={window} {str(dt)[6:]}: {measure} "
            + ", ".join(f"{n} {x:.3e}" for n, x in zip(("dq", "dk", "dv"), scores))
            + f" (tol {tol:g}); lse max|diff| {lse_err:.3e}; output with lse stored "
            f"bit-equal {torch.equal(o, o_plain_fwd)} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention_bwd {case}")
        if case == main_case:
            main_err = max(errs)
            again = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal, window=window)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            say(f"[check] flash_attention_bwd at olmo-1b's shape, a second launch on the same "
                f"inputs: bit-equal {same} (one writer per output, no atomics)")
            check(same, "flash_attention_bwd is deterministic")
            del again
        del q, k, v, dout, lse, o, o_plain_fwd, got, want, lse_want
        torch.cuda.empty_cache()

    # A bf16 q contiguous but 2 bytes past 16: the wrapper copies it.
    B, S, H, D = 1, 200, 4, 128
    buf = torch.randn(B * S * H * D + 1, generator=gen, device="cuda").to(bf)
    qm = buf[1:].view(B, S, H, D)
    k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(bf) for _ in range(2))
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    o = fa._launch(qm.clone(), k, v, True, None, lse=lse)
    got = fa.flash_attention_bwd(qm, k, v, o, lse, o)
    want = fa.flash_attention_bwd(qm.clone(), k, v, o, lse, o)
    same = qm.data_ptr() % 16 != 0 and all(torch.equal(a, b) for a, b in zip(got, want))
    say(f"[check] flash_attention_bwd q based 2 bytes past 16: equal to the aligned copy's "
        f"gradients {same} {'ok' if same else 'FAIL'}")
    check(same, "flash_attention_bwd on a misaligned q")
    return main_err


def phase_flash_bwd_timing():
    """The backward at olmo-1b's shape (4, 2048, 16, 128) causal bf16: the
    kernel, its plain version and the library's gradient
    (``F.scaled_dot_product_attention`` forward + backward, minus its
    forward, each timed in the same rounds), beside its bound; then the
    forward with and without the log-sum-exp store.

    The needed work is the five products S, dP, dV, dK and dQ, 2.5 times
    the forward's 2·B·H·D·S·(S+1) (causal), on the bf16 tensor cores' 989
    TFLOP/s; pass 2's recompute of S and dP is not counted.  The bytes
    are q, k, v, o, dO and the log-sum-exp read once and dq, dk, dv
    written once."""
    import torch
    import torch.nn.functional as F

    fa = _flash_module()
    gen = torch.Generator(device="cuda").manual_seed(12)
    B, S, H, D = PREFILL_B, PREFILL_S, 16, 128
    q, k, v = _qkv(B, S, H, H, D, torch.bfloat16, gen)
    dout = torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    o = fa._launch(q, k, v, True, None, lse=lse)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    dot = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        qt.grad = kt.grad = vt.grad = None
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True).backward(dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    q4, n = alternating({
        "kernel": lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout),
        "plain": lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, dout),
        "library": sdpa_fwd_bwd,
        "library_fwd": sdpa_fwd,
    })
    lib = q4["library"][1] - q4["library_fwd"][1]
    fwd_flops = 2 * B * H * D * S * (S + 1)
    flops = 2.5 * fwd_flops
    nbytes = 8 * B * S * H * D * 2 + B * H * S * 4
    row = _bound_row(q4, n, flops, BF16_FLOPS_PER_S, nbytes,
                     "flash_attention_bwd olmo-1b (4, 2048, 16, 128) bf16 causal",
                     "F.scaled_dot_product_attention forward + backward")
    row["library_ms"] = lib
    row["library_fwd_ms"] = q4["library_fwd"][1]
    say(f"[time] SDPA's gradient alone (forward + backward {q4['library'][1]:.4f} ms minus its "
        f"forward {q4['library_fwd'][1]:.4f} ms): {lib:.4f} ms; the kernel is {row['ms'] / lib:.2f}x it")
    fq, fn = alternating({"kernel": lambda: fa._launch(q, k, v, True, None, lse=lse),
                          "plain": lambda: fa._launch(q, k, v, True, None)})
    say(f"[time] flash_attention forward at the same shape: with the log-sum-exp stored median "
        f"{fq['kernel'][1]:.4f} ms (quartiles {fq['kernel'][0]:.4f}-{fq['kernel'][2]:.4f}), "
        f"without {fq['plain'][1]:.4f} ms ({fq['plain'][0]:.4f}-{fq['plain'][2]:.4f}) over {fn} "
        f"launches each")
    row["forward_with_lse_ms"], row["forward_without_lse_ms"] = fq["kernel"][1], fq["plain"][1]
    row["forward_quartiles_ms"] = fq
    del q, k, v, o, dout, lse, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def _lm_batch(ds, rng, batch: int) -> dict:
    import torch

    toks, labels = ds.sample(rng, batch)
    return {"tokens": torch.from_numpy(toks).cuda(), "labels": torch.from_numpy(labels).cuda()}


def phase_train_step():
    """olmo-1b at full width and depth in bf16, random weights from seed 0,
    through ``make_train_step`` with ``make_optimizer_for`` (AdamW, fp32
    state) on (2, 2048) batches of ``SyntheticLM`` tokens: one warm-up step,
    TRAIN_STEPS timed ones (host clock ending in a synchronize), each with
    its launch counts (16 flash_attention forwards with the log-sum-exp
    stored and 16 backward launches, nothing else), loss finite; one more
    step under ``torch.profiler``.  First a prefill of the same batch, whose
    16 forward launches must store no log-sum-exp."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_optimizer_for, make_prefill_step, make_train_step
    from repro_torch.models import get_model

    fa = _flash_module()
    cfg = get_config("olmo-1b")
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = make_optimizer_for(cfg)
    state = opt.init(params)
    step = make_train_step(model, opt)
    ds = SyntheticLM(cfg.vocab_size, TRAIN_S, seed=0)
    rng = np.random.default_rng(0)
    batches = [_lm_batch(ds, rng, TRAIN_B) for _ in range(TRAIN_STEPS + 2)]
    tag = "[train] olmo-1b bf16"

    stores = []
    launch = fa._launch

    def spy(*a, **kw):
        stores.append(kw.get("lse") is not None)
        return launch(*a, **kw)

    fa._launch = spy
    try:
        make_prefill_step(model)(params, {"tokens": batches[0]["tokens"]})
        prefill_stores = list(stores)
        stores.clear()
        params, state, loss = step(params, state, batches[0])   # warm-up
        torch.cuda.synchronize()
        train_stores = list(stores)
    finally:
        fa._launch = launch
    say(f"{tag}: prefill's forward launches storing the log-sum-exp: {sum(prefill_stores)} of "
        f"{len(prefill_stores)}; a train step's: {sum(train_stores)} of {len(train_stores)}")
    L = cfg.n_layers
    check(len(prefill_stores) == L and not any(prefill_stores),
          f"the prefill's {L} forward launches store no log-sum-exp")
    check(len(train_stores) == L and all(train_stores),
          f"a train step's {L} forward launches store the log-sum-exp")
    torch.cuda.reset_peak_memory_stats()
    times, losses, all_launches = [], [], []
    for b in batches[1:TRAIN_STEPS + 1]:
        zero_counts()
        t0 = time.monotonic()
        params, state, loss = step(params, state, b)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        all_launches.append(counts())
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    q1, med, q3 = quartiles(times)
    only = dict.fromkeys(KERNELS, 0) | {"flash_attention": L, "flash_attention_bwd": L}
    say(f"{tag}: {model.param_count(params):,} params, batch ({TRAIN_B}, {TRAIN_S}): train step "
        f"median {med * 1e3:.1f} ms, quartiles {q1 * 1e3:.1f}-{q3 * 1e3:.1f} ms over "
        f"{TRAIN_STEPS} steps (each {', '.join(f'{t * 1e3:.1f}' for t in times)}); losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; launches a step {all_launches[-1]}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(all(math.isfinite(x) for x in losses), "train step losses finite")
    check(all(n == only for n in all_launches),
          f"a train step launches {L} flash_attention forwards and {L} backwards, got "
          f"{all_launches}")
    zero_counts()
    holder = {}

    def traced():
        holder["out"] = step(params, state, batches[-1])

    trace = _trace_prefill(traced, tag, "train step")
    check(counts() == only, "traced train step launches")
    del params, state, holder, batches
    torch.cuda.empty_cache()
    return {"step_s": med, "step_s_quartiles": (q1, med, q3), "step_s_runs": times,
            "losses": losses, "launches": all_launches[-1], "peak_bytes": peak,
            "trace": trace, "prefill_lse_stores": sum(prefill_stores)}


def phase_trainer_entry():
    """The trainer as a user calls it: ``repro_torch.launch.train.main``
    for olmo-1b at full width, 8 steps of (2, 2048); it must return 0 (its
    exit rule: the last loss below the first)."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    buf = io.StringIO()
    t0 = time.monotonic()
    zero_counts()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--arch", "olmo-1b", "--steps", "8", "--batch", "2", "--seq", "2048"])
    wall = time.monotonic() - t0
    launches = counts()
    text = buf.getvalue()
    for line in text.splitlines():
        say(f"[trainer] {line}")
    m = re.search(r"done: loss ([0-9.naif]+) -> ([0-9.naif]+)", text)
    first, last = (float(m.group(1)), float(m.group(2))) if m else (None, None)
    say(f"[trainer] exit code {rc} in {wall:.1f} s; first loss {first}, last {last}; "
        f"launches {launches}")
    check(rc == 0, "repro_torch.launch.train.main returns 0 (the loss fell)")
    L = get_config("olmo-1b").n_layers
    check(launches["flash_attention"] == 8 * L and launches["flash_attention_bwd"] == 8 * L,
          "the trainer ran its 8 steps through both flash kernels")
    torch.cuda.empty_cache()
    return {"rc": rc, "first_loss": first, "last_loss": last, "wall_s": wall,
            "launches": launches}


def _lora_setup(cfg, device, seed_w: int, seed_a: int, silos, opt_fn):
    """Model, LoRA config, injected params and FL clients for federated
    LoRA: ``loss = model.loss(lora_effective(p))``, the optimizer masked to
    the ``.lora_`` leaves."""
    import torch
    from repro_torch.federated import FLClient
    from repro_torch.models import get_model
    from repro_torch.models.fl_models import LoRAConfig, inject_lora, lora_effective
    from repro_torch.optim import masked

    model = get_model(cfg)
    lcfg = LoRAConfig(rank=cfg.lora_rank, alpha=cfg.lora_alpha, targets=cfg.lora_targets)
    params = model.init(torch.Generator(device=device).manual_seed(seed_w), device)
    params = inject_lora(params, torch.Generator(device=device).manual_seed(seed_a), lcfg)

    def loss_fn(p, b):
        return model.loss(lora_effective(p, lcfg), {"tokens": b[0], "labels": b[1]})

    opt = masked(opt_fn(cfg), ".lora_")
    clients = [FLClient(s.client_id, s, loss_fn, opt, batch_size=2, device=device)
               for s in silos]
    return model, params, clients


def phase_lora_rounds():
    """Federated LoRA at full width: olmo-1b in bf16 ``with_lora(2)`` (rank-2
    adapters on wq, wk, wv and wo, fp32 factors), LORA_SILOS
    ``make_lm_silos`` silos of 2048-token sequences (4 train, 2 test each,
    batch 2), ``FLClient(loss_fn=model.loss o lora_effective,
    optimizer=masked(make_optimizer_for(cfg), ".lora_"))`` under
    ``AsyncFLServer(schema=lora_adapter_schema())``: 2 rounds uncompressed,
    then 2 with int8 group deltas (a second server from the first's
    weights).  After every round every non-adapter leaf must be bit-equal to
    its initial value; the adapters must have moved; the round's message
    log must carry the adapters group's wire bytes as
    ``measure_messages(schema=...)`` counts them, and the fold must have
    seen that many bytes a silo; an int8 round launches ``dequant_fold``
    once a silo.  No checkpoints here (the barrier path writes them)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_silos
    from repro_torch.federated import AsyncFLServer
    from repro_torch.federated.messages import measure_messages
    from repro_torch.launch.steps import make_optimizer_for
    from repro_torch.models.fl_models import lora_adapter_schema
    from repro_torch.utils.tree import keystr, tree_flatten_with_path

    cfg = get_config("olmo-1b").with_lora(2)
    silos = make_lm_silos(LORA_SILOS, cfg.vocab_size, TRAIN_S, [(4, 2)] * LORA_SILOS, seed=0)
    model, params0, clients = _lora_setup(cfg, "cuda", 0, 1, silos, make_optimizer_for)
    leaves0 = [(keystr(p), t.clone()) for p, t in tree_flatten_with_path(params0)[0]]
    n_adapter = sum(t.numel() for k, t in leaves0 if ".lora_" in k)
    n_total = sum(t.numel() for _, t in leaves0)
    tag = "[lora] olmo-1b bf16 rank 2"
    say(f"{tag}: {n_total:,} parameters, {n_adapter:,} of them adapters "
        f"({sum('.lora_' in k for k, _ in leaves0)} factor leaves), {LORA_SILOS} silos")
    L = cfg.n_layers  # train: 2 batches a silo, eval: 1
    per_round = {"flash_attention": LORA_SILOS * (2 + 1) * L,
                 "flash_attention_bwd": LORA_SILOS * 2 * L}
    rounds_out = []

    def check_round(round_idx, params):
        moved = 0
        for (k, t0), (p, t) in zip(leaves0, tree_flatten_with_path(params)[0]):
            check(keystr(p) == k, "leaf order")
            if ".lora_" in k:
                moved += int(not torch.equal(t, t0))
            else:
                check(torch.equal(t, t0), f"round {round_idx}: base leaf {k} bit-equal")
        check(moved > 0, f"round {round_idx}: the adapters moved")
        return None

    params = params0
    schema = lora_adapter_schema()
    for codec, first_round in ((None, 1), ("int8", 3)):
        server = AsyncFLServer(clients, params, schema=schema, compression=codec,
                               measure_round_messages=True, post_round_hook=check_round)
        server.start_round = first_round
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.monotonic()
        run = server.run(first_round + 1)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        params = run.final_params
        n_rounds = len(run.rounds)
        want_launches = dict.fromkeys(KERNELS, 0) | {
            k: n * n_rounds for k, n in per_round.items()}
        if codec == "int8":
            want_launches["dequant_fold"] = LORA_SILOS * n_rounds
        check(launches == want_launches, f"{codec} rounds launch {want_launches}, got {launches}")
        ref_log = measure_messages(params, run.rounds[-1].metrics, compression=codec,
                                   schema=schema)
        wire = server.agg_engine.stats.total_wire_bytes
        for rec in run.rounds:
            log = rec.message_log
            check(log.group_wire_bytes == ref_log.group_wire_bytes
                  and log.c_msg_train_bytes == ref_log.c_msg_train_bytes,
                  f"round {rec.round_idx}: per-group wire bytes as measure_messages counts them")
            say(f"{tag} round {rec.round_idx} ({codec or 'uncompressed'}): loss "
                f"{rec.metrics['loss']:.4f}; train {rec.train_time_s:.3f} s, fold "
                f"{rec.agg_time_s:.4f} s, eval {rec.eval_time_s:.3f} s, checkpoint "
                f"{rec.checkpoint_time_s:.3f} s; c_msg_train {log.c_msg_train_bytes:,} B a silo "
                f"(group wire {log.group_wire_bytes}, codec {log.codec}) against dense fp32 "
                f"{log.c_msg_train_dense_bytes:,} B: {log.compression_ratio:.1f}x")
            rounds_out.append({"round": rec.round_idx, "codec": codec,
                               "loss": rec.metrics["loss"], "train_s": rec.train_time_s,
                               "fold_s": rec.agg_time_s, "eval_s": rec.eval_time_s,
                               "checkpoint_s": rec.checkpoint_time_s,
                               "c_msg_train_bytes": log.c_msg_train_bytes,
                               "dense_bytes": log.c_msg_train_dense_bytes,
                               "group_wire_bytes": log.group_wire_bytes})
        check(wire == LORA_SILOS * n_rounds * ref_log.c_msg_train_bytes,
              "the folds saw each silo's structured frame")
        say(f"{tag}: {codec or 'uncompressed'} rounds in {wall:.1f} s, launches {launches}, "
            f"max_memory_allocated {peak / 2**30:.2f} GiB")
        rounds_out[-1]["launches"] = launches
        rounds_out[-1]["peak_bytes"] = peak
        rounds_out[-1]["wall_s"] = wall
    del params, params0, clients, leaves0, server, run
    torch.cuda.empty_cache()
    return {"rounds": rounds_out, "adapter_elems": n_adapter, "total_elems": n_total}


def phase_train_reference_check():
    """Reduced olmo-1b in fp32 on the card (kernels) and on the CPU (plain
    versions) from the same weights: one ``make_train_step`` step (loss
    within 1e-4; every leaf within 1e-4 relative L2: AdamW's first step
    moves an element by about lr whatever its gradient's size, so an
    element whose gradient is rounding noise can differ by ~lr), and one
    federated LoRA round (``with_lora(2)``, 2 silos, uncompressed, fold
    cost fixed so the trace's times are arithmetic): adapters within 1e-4,
    base leaves bit-equal, event traces equal."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, make_lm_silos
    from repro_torch.federated import AsyncFLServer
    from repro_torch.launch.steps import make_optimizer_for, make_train_step
    from repro_torch.models import get_model
    from repro_torch.models.fl_models import lora_adapter_schema
    from repro_torch.utils.tree import keystr, tree_flatten, tree_flatten_with_path, tree_map
    import numpy as np

    cfg = get_config("olmo-1b").reduced().with_overrides(dtype="float32", param_dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    batch = _lm_batch(SyntheticLM(cfg.vocab_size, 64, seed=1), np.random.default_rng(1), 2)
    runs = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), params)
        opt = make_optimizer_for(cfg)
        zero_counts()
        new, _, loss = make_train_step(model, opt)(p, opt.init(p), tree_map(
            lambda t: t.to(device), batch))
        runs[device] = ([t.cpu() for t in tree_flatten(new)[0]], float(loss),
                        counts()["flash_attention_bwd"])
    (cp, cl, cn), (pp, pl, pn) = runs["cuda"], runs["cpu"]
    worst = max(((a.double() - b.double()).norm() / b.double().norm()).item()
                for a, b in zip(cp, pp))
    ok = abs(cl - pl) <= 1e-4 * max(1.0, abs(pl)) and worst <= 1e-4
    say(f"[reference] reduced olmo-1b fp32 train step, card against CPU: loss {cl:.6f} / "
        f"{pl:.6f}, worst leaf relative L2 {worst:.3e} (tol 1e-4); flash_attention_bwd "
        f"launches card {cn}, cpu {pn} {'ok' if ok else 'FAIL'}")
    check(ok and cn == cfg.n_layers and pn == 0, "reduced train step: card agrees with the CPU")

    lcfg = cfg.with_lora(2)
    out = {"train_loss": (cl, pl), "train_worst_rel_l2": worst}
    results = {}
    for device in ("cuda", "cpu"):
        silos = make_lm_silos(2, lcfg.vocab_size, 32, [(4, 2), (4, 2)], seed=2)
        _, p0, clients = _lora_setup(lcfg, "cpu", 6, 7, silos, make_optimizer_for)
        for c in clients:
            c.device = torch.device(device)
        server = AsyncFLServer(clients, p0, schema=lora_adapter_schema(), fold_cost_s=0.01,
                               device=device)
        zero_counts()
        run = server.run(1)
        trace = []
        for e in server.bus.trace:
            d = dataclasses.asdict(e)
            if type(e).__name__ in ("RoundDispatched", "CheckpointSaved", "RecoveryCompleted"):
                d = {k: v for k, v in d.items() if k not in ("time_s", "span_s", "overhead_s")}
            trace.append((type(e).__name__, d))
        results[device] = ([(keystr(k), t.cpu()) for k, t in
                            tree_flatten_with_path(run.final_params)[0]],
                           [(keystr(k), t.cpu()) for k, t in tree_flatten_with_path(p0)[0]],
                           trace, counts()["flash_attention_bwd"])
    (cpar, cp0, ctr, cn), (ppar, pp0, ptr, pn) = results["cuda"], results["cpu"]
    base_equal = all(torch.equal(a, b) and torch.equal(a, a0) for (k, a), (_, b), (_, a0)
                     in zip(cpar, ppar, cp0) if ".lora_" not in k)
    ad_err = max((a - b).abs().max().item() for (k, a), (_, b) in zip(cpar, ppar)
                 if ".lora_" in k)
    ok = base_equal and ad_err <= 1e-4 and ctr == ptr
    say(f"[reference] reduced olmo-1b fp32 federated LoRA round (2 silos), card against CPU: "
        f"adapters max|diff| {ad_err:.3e} (tol 1e-4), base bit-equal {base_equal}, traces "
        f"equal {ctr == ptr}; flash_attention_bwd launches card {cn}, cpu {pn} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok and cn > 0 and pn == 0, "reduced federated LoRA round: card agrees with the CPU")
    out.update(lora_adapter_max_diff=ad_err, lora_base_equal=base_equal,
               lora_traces_equal=ctr == ptr)
    return out


def main() -> int:
    import torch
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce  # noqa: F401 (fail early)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.monotonic()
    smi = phase_device()
    sass, ptxas = phase_build()
    main_err = phase_kernel_check()
    dq_err = phase_dequant_check()
    flash_err = phase_flash_check()
    bwd_err = phase_flash_bwd_check()
    ssd_err = phase_ssd_check()
    timing = phase_kernel_timing()
    dq_timing = phase_dequant_timing()
    zoo_timing = phase_zoo_timing()
    bwd_timing = phase_flash_bwd_timing()
    fold = phase_fold_breakdown()
    compressed_split = phase_compressed_breakdown()
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_ckpt_") as d:
        path = phase_main_path(Path(d))
    compressed = phase_compressed_path()
    reference = phase_reference_check()
    compressed_reference = phase_compressed_reference_check()
    zoo = phase_zoo_paths()
    zoo_reference = phase_zoo_reference_check()
    train_step = phase_train_step()
    trainer = phase_trainer_entry()
    lora = phase_lora_rounds()
    train_reference = phase_train_reference_check()

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
    for name, src, replaces, launches, err in (
            ("flash_attention", "flash_attention.cu", "flash_attention.py:30",
             zoo["olmo-1b bf16"]["prefill_launches"]["flash_attention"], flash_err),
            ("ssd_chunk_scan", "ssd_scan.cu", "ssd_scan.py:27",
             zoo["mamba2-130m bf16"]["prefill_launches"]["ssd_chunk_scan"], ssd_err)):
        row = zoo_timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches,
            "max_abs_err": err,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    kernels.insert(3, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:97",
        "launches": train_step["launches"]["flash_attention_bwd"],
        "max_abs_err": bwd_err,
        "ms": bwd_timing["ms"],
        "plain_ms": bwd_timing["plain_ms"],
        "bound_ms": bwd_timing["bound_ms"],
        "bound_by": bwd_timing["bound_by"],
        "library_ms": bwd_timing["library_ms"],
    })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "nvidia_smi": smi, "sass_counts": sass, "ptxas": ptxas, "kernels": kernels, "timing": timing, "fold": fold, "path": path,
        "reference": reference, "dequant_timing": dq_timing,
        "compressed_breakdown": compressed_split, "compressed_path": compressed,
        "compressed_reference": compressed_reference, "zoo_timing": zoo_timing, "zoo": zoo,
        "zoo_reference": zoo_reference, "flash_bwd_timing": bwd_timing,
        "train_step": train_step, "trainer": trainer, "lora": lora,
        "train_reference": train_reference, "seconds": time.monotonic() - t_start,
    }, indent=1))
    say(f"[done] {time.monotonic() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
