#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX
or of the JAX package.  In order it:

  1. prints the card (``nvidia-smi`` name and power limit) and turns TF32
     off for matmuls and cuDNN convolutions;
  2. builds every kernel of the port's paths from ``src/repro_torch/
     kernels/csrc`` with nvcc (one process per source, all started
     together), prints ptxas's registers, spills and shared memory per
     kernel (the flash backward's wgmma kernels and the SSD backward's
     kernels must not spill) and, where ``cuobjdump`` is found, the count
     of wgmma (HGMMA), TMA load (UTMALDG) and mma.sync (HMMA) instructions
     in each library's SASS;
  3. holds each kernel against its plain PyTorch version on the card, over
     the CPU tests' sweeps and at the paths' shapes (``dequant_fold`` bit
     for bit, on aligned and misaligned payloads; ``flash_attention`` over
     MHA / GQA / MQA at both head widths, windows inside and across tiles,
     full attention, ragged S, keys longer or shorter than the queries
     (full, causal and windowed, one key, one query), fp32 and bf16,
     olmo-1b's prefill, jamba-1.5-large-398b's (64 query over 8 KV heads of
     128) and whisper-small's three attention calls;
     ``ssd_chunk_scan`` over the reference's sweep, head counts and chunks
     off the kernel's tiles, the state continuation, the O(L) recurrence and
     the prefills of mamba2-130m and jamba (256 SSD heads); the main
     paths' shapes each relaunched bit-equal);
  4. times each kernel at its path's shape (CUDA events around each
     launch after warm-up; 4 rounds of 10 launches each of kernel, plain
     version and one PyTorch library call computing the same function,
     where there is one, in alternating order; median and quartiles)
     beside its bound, with the card's clocks and power after (both flash
     kernels also at granite's and jamba's GQA shapes and at whisper-small's
     encoder, 1500 x 1500, and cross-attention, 448 queries over 1500 keys,
     against SDPA; the scan and its backward also at jamba's); splits the
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
     Then the MoE family the same way: granite-moe-1b-a400m and
     deepseek-moe-16b (28 layers, 16.3 B parameters) in bf16, each prefill
     with 24 / 28 flash launches, its dropped assignments counted and two
     runs' logits bit-equal, and the prefill-against-serving check at a
     capacity factor that drops nothing, in bf16 and in fp32 (deepseek-moe
     cut to 2 layers in fp32);
     Then the encoder-decoder family: whisper-small (12 + 12 layers) in
     bf16, an (8, 448) prefill over (8, 1500, 768) frames with exactly 36
     flash launches (12 encoder, 12 decoder self, 12 cross with Sk != Sq),
     timed 5 times and traced once, the serve driver, and the prefill
     against serving the same tokens one by one from the cross cache that
     ``decode_forward(return_cache=True)`` fills, in bf16 and in fp32;
     Then the hybrid family: jamba-1.5-large-398b at full width, one
     superblock of 8 layers (``JAMBA_SERVE_CUT``: 4 of its 16 experts,
     16.2 B parameters) in bf16, a (4, 2048) prefill with 1 flash and 7 SSD
     scan launches, timed 5 times and traced once, the serve driver, and
     the prefill against serving at capacity factor E/K, in bf16 and in
     fp32 (at ``JAMBA_TRAIN_CUT``);
  9. runs reduced olmo-1b, mamba2-130m, granite-moe-1b-a400m,
     deepseek-moe-16b, whisper-small and jamba in fp32 on the card and on the CPU
     from the same weights: prefill logits, greedy tokens and (MoE) every
     layer's expert choices and keep masks;
 10. trains olmo-1b at full width (bf16, (2, 2048) batches): the flash
     backward kernel held against its plain version over the forward's
     cases and its own tile edges, keys longer or shorter than the
     queries, whisper-small's encoder and cross-attention relaunched
     bit-equal (phase 3), timed against SDPA's gradient (phase 4, with each of its
     two kernels' device time, and the forward with and without its
     log-sum-exp store), five timed
     ``make_train_step`` steps and one traced, each with 16 forward and 16
     backward launches, and ``repro_torch.launch.train.main`` for 8 steps
     (exit 0: the loss fell);
 11. runs federated LoRA on olmo-1b at full width (``with_lora(2)``, 4
     silos): 2 rounds uncompressed and 2 with int8 adapter deltas under
     ``AsyncFLServer(schema=lora_adapter_schema())``, the base bit-equal
     and the adapters moved after every round, per-group wire bytes as
     ``measure_messages`` counts them, ``dequant_fold`` once a silo in an
     int8 round;
 12. trains mamba2-130m at full width and depth (bf16, (4, 2048)
     batches): the SSD backward kernel held against its plain version
     (phase 3: fp32 and bf16, ragged chunks, P and N below their maxima,
     odd H, a relaunch bit-equal, the whole scan's gradient from an
     initial state, refused inputs with no launch), timed beside the
     forward kernel (phase 4, before any phase that traces: both again
     behind a sleep kernel for their device spans, so the host share of a
     call is its time less its span; each of its three kernels' device
     time, its scratch, and its bounds at 3xTF32 and as fp32 FMAs), five timed ``make_train_step`` steps and one
     traced, each with 24 forward and 24 backward launches, and ``python -m
     repro_torch.launch.train --arch mamba2-130m`` in its own process
     (exit 0);
 13. runs 2 FedAvg rounds (``FLServer``) of 2 mamba2-130m silos at full
     width, each fold checked against the plain weighted mean on the
     card, ``fedavg_reduce`` once a round;
 14. trains granite-moe-1b-a400m at full width and depth (bf16, (2, 2048)
     batches; both flash kernels at its GQA head width 64 timed against
     SDPA in phase 4): two gradients from the same weights and batch
     bit-equal, five timed steps and one traced, each with 24 forward and
     24 backward flash launches, and ``python -m repro_torch.launch.train
     --arch granite-moe-1b-a400m`` with the trainer's defaults (exit 0);
 15. runs 2 FedAvg rounds of 2 granite-moe-1b-a400m silos at full width,
     as phase 13 (``fedavg_reduce`` over L = 1,334,628,352);
 16. trains whisper-small at full width and depth (bf16, (8, 448) token
     batches over (8, 1500, 768) frames): two gradients bit-equal, five
     timed steps and one traced, each with 36 forward and 36 backward flash
     launches, and ``python -m repro_torch.launch.train --arch
     whisper-small`` with the trainer's defaults (exit 0);
 17. trains jamba-1.5-large-398b at its training cut (``JAMBA_TRAIN_CUT``:
     one superblock, d_ff 1024, 5.79 B parameters; bf16 with the config's
     bf16 AdamW moments, (1, 2048) batches): two gradients bit-equal, five
     timed steps and one traced, each with 1 + 7 forward and 1 + 7
     backward launches, the loss falling (no trainer process: its CLI
     takes no cut);
 18. runs reduced olmo-1b, mamba2-130m, granite-moe-1b-a400m,
     deepseek-moe-16b, whisper-small and jamba in fp32 on the card and on the CPU
     from the same weights: one train step each, and one federated LoRA
     round of olmo-1b over 2 silos (adapters within 1e-4, base bit-equal,
     traces equal);
 19. runs the two-level hierarchy at the paper's FEMNIST width: dyadic
     silos (no sum rounds) folded through four region partitions, dense and
     fp16 (``dequant_fold``), with the sequential parent and the sharded one
     (an all-reduce over an NCCL process group of one), each bit-equal to
     the flat fold; the structured full-coverage route bit-equal too, int8
     within 1e-6; one partial add and the parent's fold of three regions
     timed beside their bounds.  Then ``HierarchicalFLServer`` over the
     five silos of ``femnist_application()`` in the regions of
     ``aws_gcp_environment()`` (§5.7), int8, 4 rounds with a deadline, a
     revocation re-requested in its region and an update carried in its
     region, against a flat ``AsyncFLServer`` twin (round 1 within 1e-6,
     every round's fold within 1e-6 of the flat fold of the same updates);
     2 rounds of a cohort of 4; federated LoRA of olmo-1b through two
     regions against its flat twin; and ``fedavg_stacked`` over 4 FEMNIST
     trees (one ``fedavg_reduce`` launch);
 20. runs the pod round: on an NCCL process group of one, a
     ``make_host_mesh(data=1, model=1)`` and a ``pod=1`` ``DeviceMesh`` (a
     ``data=2`` one refused), olmo-1b's parameters placed by ``param_specs``
     through ``distribute`` (every local shard bit-equal) and
     ``batch_iterator`` yielding DTensors; then ``make_fl_round_step`` for
     olmo-1b and mamba2-130m at full width and depth in bf16, 2 pods x 4
     local steps of (2, 2048) and (4, 2048), 2 rounds: 128 + 128 flash or
     192 + 192 SSD launches and one ``fedavg_reduce`` a round, the pods
     bit-equal after each barrier, round 1 bit-equal to a sequential twin,
     the round's wall time split into local steps and the barrier (the
     ``fedavg_reduce`` launch by CUDA events beside its bound), peak
     memory; a reduced olmo-1b pod round card against CPU;
 21. runs the live transport at the paper's FEMNIST width: the five
     silos of ``femnist_application()`` as ``ThreadWorkerPool`` workers
     behind ``SocketTransport`` on loopback, int8 updates folded by
     ``dequant_fold`` in this process (one launch a folded update), 3
     ``LiveRoundDriver`` rounds under a ``FaultPlan`` (round 2: a crash
     and a corrupt frame; round 3: a revocation, moved to another VM by
     the §4.4 ``DynamicScheduler``, and a hang, found by heartbeats whose
     bound is sized from this run's GIL holds and dispatch time); each
     round's wall time split, bytes and loopback GB/s, crash to
     re-arrival and hang to detection, the cost model fed the measured
     sizes, round 1 traced (the device's idle share) and replayed in
     process on its recorded arrivals (params within 2e-5, equal
     ``chaos_signature``);
 22. runs 2 mamba2-130m silos (full width and depth, bf16) as spawned
     ``ProcessWorkerPool`` children that build their client and template
     on the card and raise unless their weights are CUDA tensors and both
     SSD kernels launched in them; 2 int8 rounds, one child terminated by
     an eval-phase revocation and respawned; each fold against the plain
     weighted fold of the same decoded deltas;
 23. runs ``tests/test_chaos.py``'s soak at its toy size with tensors on
     the card: five rounds, all seven fault kinds, the live and the
     virtual-clock drivers' signatures, pairing and folded weight.
For each path every kernel's launch count is set to 0 just before and
read just after.

Any failed check exits non-zero.  The line before the last is the
``{"kernels": [...]}`` record; the last is ``{"ok": true, "device": ...}``.
Details also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# jamba's train phase runs at 75.9 of the card's 79.18 GiB: with the
# allocator's fixed segments, 3.6 GiB of cached blocks too small for its
# slices once left its traced step out of memory.  Segments that grow in
# place do not fragment so.  Read when CUDA first allocates, so set here
# (the trainer's and the live phases' child processes inherit it).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

from repro_torch.roofline import hardware as H100  # noqa: E402 (the H100 SXM data sheet's table)

HBM_BYTES_PER_S = H100.HBM_BANDWIDTH
FP32_FLOPS_PER_S = H100.PEAK_FLOPS_FP32     # fp32 outside the tensor cores
BF16_FLOPS_PER_S = H100.PEAK_FLOPS_BF16     # bf16 tensor cores, dense
TF32_FLOPS_PER_S = H100.PEAK_FLOPS_TF32     # tf32 tensor cores, dense
PAPER_L = 164_187_070       # FemnistConfig() parameter count
N_SILOS = 4
TIMING_ROUNDS = 4       # rounds of kernel / plain / library, order alternating
TIMED_PER_ROUND = 10    # launches of each per round: 40 samples each
QUEUE_CYCLES = 2_000_000   # a ~1 ms sleep kernel at the H100's ~1.98 GHz, held ahead of a call
PREFILL_RUNS = 5        # timed full-width prefills a model, after one warm-up
PREFILL_B, PREFILL_S = 4, 2048   # the zoo's full-width prefill batch
KERNELS = ("fedavg_reduce", "dequant_fold", "flash_attention", "flash_attention_bwd",
           "ssd_chunk_scan", "ssd_intra_chunk_bwd")
TRAIN_B, TRAIN_S = 2, 2048      # the zoo's full-width training batch
TRAIN_STEPS = 5                 # timed train steps, after one warm-up
LORA_SILOS = 4
LORA_LAYERS = 4                 # olmo-1b's depth in the LoRA rounds (of 16; full width)
SSM_B = 4                       # mamba2-130m's training batch (4, 2048)
MOE_BF16_TOL = 0.2              # MoE prefill against token-by-token serving, bf16 (phase_moe_paths)
ZOO_SILOS = 2                   # silos of the zoo's FedAvg rounds (mamba2-130m, granite-moe)
# jamba-1.5-large-398b (arXiv:2403.19887) on one card.  Its 72 layers are 9
# superblocks of 8 (7 Mamba, 1 attention; MoE every second layer), and one
# superblock at the published widths holds 45.1 B parameters, so both cuts
# keep one superblock (n_layers 72 -> 8) and every width but the one named:
# - serving: n_experts 16 -> 4 (top_k 2 kept, so a token's routed work is
#   the same; the router is 4 wide): 16,153,237,504 parameters, 32.3 GB in
#   bf16;
# - training: d_ff 24576 -> 1024 (dense and expert FFNs, 16 experts top 2):
#   5,785,311,232 parameters; weights, gradients and the config's bf16 AdamW
#   moments take 8 B a parameter, and the out-of-place update holds a second
#   copy of weights and moments.
JAMBA = "jamba-1.5-large-398b"
JAMBA_SERVE_CUT = {"n_layers": 8, "n_experts": 4}
JAMBA_TRAIN_CUT = {"n_layers": 8, "d_ff": 1024}
JAMBA_ATTN = (64, 8, 128)              # query heads, KV heads (GQA 8:1), head width
JAMBA_SSD = (256, 64, 128, 256)        # SSD heads (d_inner 16384), head dim, state, chunk
JAMBA_BF16_TOL = 0.5    # jamba's bf16 prefill against its token-by-token serving (phase_hybrid_paths)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(*parts: object) -> None:
    print(*parts, flush=True)


def cuda_times(fn, n: int, queued: bool = False) -> list:
    """Device times (ms) of ``n`` calls of ``fn``, each between CUDA events.
    A call's time counts its host work before its first launch, during
    which the card waits.  ``queued``: a ~1 ms sleep kernel goes ahead of
    each call's start event, so the host has enqueued the whole call before
    the card reaches that event, and the events time its device span alone."""
    import torch

    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
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


def alternating(fns: dict, queued: tuple = ()) -> tuple:
    """Quartiles (ms) of each of ``fns`` over TIMING_ROUNDS rounds of
    TIMED_PER_ROUND launches, in alternating order, after 5 warm-up calls
    of each; also the sample count.  The names in ``queued`` are timed
    behind a sleep kernel (``cuda_times``): their device span alone."""
    for fn in fns.values():
        for _ in range(5):
            fn()
    samples = {k: [] for k in fns}
    for r in range(TIMING_ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            samples[k] += cuda_times(fns[k], TIMED_PER_ROUND, k in queued)
    return {k: quartiles(v) for k, v in samples.items()}, len(samples[next(iter(fns))])


def _wrappers() -> dict:
    from repro_torch.kernels.dequant_fold import dequant_fold
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, ssd_intra_chunk_bwd

    return {"fedavg_reduce": fedavg_reduce, "dequant_fold": dequant_fold,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "ssd_chunk_scan": ssd_chunk_scan, "ssd_intra_chunk_bwd": ssd_intra_chunk_bwd}


def zero_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for fn in _wrappers().values():
        fn.launches = 0


def counts() -> dict:
    """Every kernel's launch count, read just after a path is driven."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def _nonzero(launches: dict) -> dict:
    """The kernels of a ``counts()`` that launched."""
    return {k: n for k, n in launches.items() if n}


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
    free, total = torch.cuda.mem_get_info(0)
    say(f"[device] torch.cuda.mem_get_info total {total / 2**30:.2f} GiB, free {free / 2**30:.2f} "
        f"GiB (table: HBM_BYTES {H100.HBM_BYTES / 1e9:.0f} GB, HBM_BYTES_VISIBLE "
        f"{H100.HBM_BYTES_VISIBLE / 2**30:.2f} GiB)")
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    libs = _build.build(["fedavg_reduce", "dequant_fold", "flash_attention",
                         "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd"])
    say(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} "
        f"in {time.monotonic() - t0:.1f} s")
    ptxas, spills, entry = [], {}, ""
    for name in libs:
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                ptxas.append(f"{name}: {line.strip()}")
                say(f"[build] {ptxas[-1]}")
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (name == "ssd_scan_bwd"
                      or (name == "flash_attention_bwd" and "wgmma" in entry)):
                spills[f"{name}:{entry}"] = int(m.group(1)) + int(m.group(2))
    flash = {k: v for k, v in spills.items() if k.startswith("flash")}
    ssd = {_kernel_name(k): v for k, v in spills.items() if k.startswith("ssd")}
    say(f"[build] flash_attention_bwd wgmma kernels, spilled bytes: {flash}")
    say(f"[build] ssd_scan_bwd kernels, spilled bytes: {ssd}")
    check(len(flash) == 4 and not any(flash.values()),
          "the flash backward's four wgmma kernels (dK/dV and dQ at D 64 and 128) do not spill")
    check(len(ssd) == 5 and not any(ssd.values()),
          "the SSD backward's kernels (bwd_heads, bwd_chunk at fp32 and bf16, bwd_dA) do not spill")
    return sass_counts(libs), ptxas


def _kernel_name(mangled: str) -> str:
    """``bwd_heads<bf16>`` (or ``bwd_dA``) for a mangled entry of the SSD
    backward, the name itself otherwise."""
    m = re.search(r"\d(bwd_[A-Za-z]+?)(I13__nv_bfloat16E|IfE|E)", mangled)
    if not m:
        return mangled
    return m.group(1) + {"E": "", "IfE": "<fp32>"}.get(m.group(2), "<bf16>")


def sass_counts(libs: dict) -> dict:
    """Counts of tensor-core and TMA instructions in the built libraries'
    SASS (``cuobjdump -sass``), where ``cuobjdump`` is found: the bf16
    flash kernels, forward and backward, must issue wgmma (HGMMA) and TMA
    loads (UTMALDG), the backward no mma.sync (HMMA) at all, the scan its
    bf16 scores on mma.sync, the scan's backward its products on the tensor
    cores (HMMA or HGMMA)."""
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
    check(out["ssd_scan_bwd"]["HMMA"] + out["ssd_scan_bwd"]["HGMMA"] > 0,
          "the scan backward library runs its products on the tensor cores")
    check(out["flash_attention_bwd"]["HGMMA"] > 0 and out["flash_attention_bwd"]["UTMALDG"] > 0
          and out["flash_attention_bwd"]["HMMA"] == 0,
          "the flash backward library issues wgmma and TMA loads, and no mma.sync")
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


def _fold_parts(trees: list, weights: list, n: int = 5) -> dict:
    """Where the barrier fold's time goes: the engine's flatten, reduce
    (the ``fedavg_reduce`` launch) and unflatten on the given client trees
    on the card (CUDA events, median of ``n`` after warm-up), beside the
    whole ``aggregate`` call; also the reduce's byte bound ((N + 1)·L fp32
    elements read or written once) and the host time of a first
    allocation of the (N, L) buffer, made after ``empty_cache`` so that
    nothing cached fits it."""
    import torch
    from repro_torch.federated.agg_engine import AggregationEngine, plan_for

    engine = AggregationEngine()
    plan = plan_for(trees[0])
    stacked = plan.flatten_stack(trees)
    w = torch.tensor(weights, device="cuda")
    red = engine.reduce_flat(stacked, w)
    parts = {
        "flatten_stack_ms": cuda_ms(lambda: plan.flatten_stack(trees), n),
        "reduce_ms": cuda_ms(lambda: engine.reduce_flat(stacked, w), n),
        "unflatten_ms": cuda_ms(lambda: plan.unflatten(red), n),
        "aggregate_ms": cuda_ms(lambda: engine.aggregate(trees, weights), n),
        "reduce_bound_ms": (len(trees) + 1) * plan.total_elems * 4 / HBM_BYTES_PER_S * 1e3,
    }
    del stacked, red
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    buf = torch.empty((len(trees), plan.row_stride), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    parts["first_alloc_ms"] = (time.monotonic() - t0) * 1e3
    del buf
    torch.cuda.empty_cache()
    return parts


def phase_fold_breakdown():
    """Where the fold's time goes at paper width (``_fold_parts`` on 4
    FEMNIST client trees)."""
    import torch
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn

    gen = torch.Generator(device="cuda").manual_seed(2)
    trees = [init_femnist_cnn(gen, FemnistConfig(), "cuda") for _ in range(N_SILOS)]
    parts = _fold_parts(trees, [64.0] * N_SILOS)
    say("[fold] paper-width FEMNIST, 4 silos: " + ", ".join(
        f"{k} {v:.4f}" for k, v in parts.items()))
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

def _qkv(B, S, H, KV, D, dtype, gen, Sk=None):
    """q (B, S, H, D), k and v (B, Sk, KV, D) (Sk = S unless given)."""
    import torch

    Sk = S if Sk is None else Sk
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, S, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))


# whisper-small's attention calls at the (8, 448) decoder batch over 1500
# frames: (B, Sq, Sk, H, KV, D, causal) of the encoder's self-attention, the
# decoder's cross-attention and the decoder's self-attention.
WHISPER_B, WHISPER_S = 8, 448
WHISPER_ATTN = {"encoder": (WHISPER_B, 1500, 1500, 12, 12, 64, False),
                "cross": (WHISPER_B, WHISPER_S, 1500, 12, 12, 64, False),
                "decoder": (WHISPER_B, WHISPER_S, WHISPER_S, 12, 12, 64, True)}


def _two_length_cases(dt) -> list:
    """(B, Sq, Sk, H, KV, D, causal, window, dtype) with keys longer or
    shorter than the queries: full, causal and windowed, MHA / GQA / MQA, D
    64 and 128, both lengths ragged, whisper's 448 x 1500 and 1500 x 1500
    (at B 2), one key and one query, and a window that leaves the rows from
    Sk + window - 1 on with no key (they give 0)."""
    return [(2, 448, 1500, 12, 12, 64, False, None, dt),
            (2, 1500, 1500, 12, 12, 64, False, None, dt),
            (1, 300, 130, 4, 2, 128, False, None, dt), (1, 130, 300, 4, 2, 128, True, None, dt),
            (1, 300, 130, 8, 2, 64, True, None, dt), (1, 200, 100, 4, 2, 64, True, 40, dt),
            (1, 100, 700, 4, 4, 128, True, 200, dt), (1, 1000, 129, 4, 1, 64, True, 16, dt),
            (2, 64, 1, 4, 4, 64, False, None, dt), (2, 1, 300, 8, 2, 128, False, None, dt)]


def phase_flash_check():
    """flash_attention against its plain version (``causal_attention`` /
    ``full_attention``) on the card: MHA, GQA 4:1 and MQA at head widths 64
    and 128, windows 16, 64 and 100 (inside a 128-key tile) and 200 and 300
    (across tiles), full attention, ragged S (40, 100, 130, 300, 1000: below
    64 and past multiples of 64 and 128), keys longer or shorter than the
    queries (``_two_length_cases``), fp32 (2e-5) and bf16 (2e-2; the plain
    version rounds the softmax weights to bf16, the kernel keeps them in
    fp32), and the main paths' calls: olmo-1b's and deepseek-moe-16b's
    prefill (B 4, S 2048, 16 heads of 128, bf16, causal),
    granite-moe-1b-a400m's (16 query heads over 8 KV heads of 64),
    jamba-1.5-large-398b's (64 query heads over 8 KV heads of 128) and
    whisper-small's three (``WHISPER_ATTN``), whose largest error is
    returned; each of those is launched a second time and must be
    bit-equal.

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
    main_cases = [(PREFILL_B, PREFILL_S, 16, 16, 128, True, None, torch.bfloat16),
                  (PREFILL_B, PREFILL_S, 16, 8, 64, True, None, torch.bfloat16),
                  (PREFILL_B, PREFILL_S, *JAMBA_ATTN, True, None, torch.bfloat16)]
    cases = [c[:2] + c[1:] for c in cases + main_cases]   # Sk = S
    main_cases = [c[:2] + c[1:] for c in main_cases]
    cases += _two_length_cases(torch.float32) + _two_length_cases(torch.bfloat16)
    whisper = [c + (None, torch.bfloat16) for c in WHISPER_ATTN.values()]
    main_cases += whisper
    cases += whisper
    main_err = 0.0
    for case in cases:
        B, S, Sk, H, KV, D, causal, window, dt = case
        q, k, v = _qkv(B, S, H, KV, D, dt, gen, Sk)
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = 2e-2 if dt == torch.bfloat16 else 2e-5
        err = (got.float() - want.float()).abs().max().item()
        ok = (got.dtype == dt and got.shape == q.shape and bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        l2 = ""
        if dt == torch.bfloat16:
            del want
            want = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                         window=window)
            rel = rel_l2(got, want)
            ok = ok and rel <= 1e-2
            l2 = f", relative L2 against fp32 plain {rel:.3e} (tol 1e-2)"
        lengths = f"S={S}" if Sk == S else f"Sq={S} Sk={Sk}"
        say(f"[check] flash_attention B={B} {lengths} H={H} KV={KV} D={D} "
            f"{'causal' if causal else 'full'} window={window} {str(dt)[6:]}: "
            f"max|kernel-plain|={err:.3e} (tol {tol:g} abs+rel){l2} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention {case} within {tol}")
        if case in main_cases:
            main_err = max(main_err, err)
            same = torch.equal(got, flash_attention(q, k, v, causal=causal, window=window))
            say(f"[check] flash_attention at {case[:6]}, a second launch on the same inputs: "
                f"bit-equal {same}")
            check(same, "flash_attention is deterministic")
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
    (1e-3, as there), and the prefills of mamba2-130m (B 4, L 2048, 24
    heads of P 64, N 128, chunk 256) and jamba-1.5-large-398b (256 heads)
    in fp32 and in bf16 (the main paths' calls; y
    comes back in bf16, 2e-2, and as a whole within 1e-2 relative L2 of
    the plain version computed in fp32 from the same bf16 inputs: the
    output's rounding alone gives ~1e-3), and the kernel's edges (H not a
    multiple of its head group of 4, chunks of 96, 150 and 160 positions).
    At those shapes and at the edges the kernel's three outputs are also
    held against its plain version alone (2e-5 scaled), and at those shapes
    a second launch must be bit-equal; the largest error of the kernel
    alone at the two prefills' shapes in bf16 is returned.

    At jamba's shape the fp32 parts (y in fp32, the state, the kernel
    alone) are held within 1e-4 scaled, and in fp32 both versions are also
    held against the same algorithm in fp64 (``_ssd_fp64``), the kernel
    within 1e-4 scaled.  256 draws of A = -exp(N(0, 1)) reach |A| ~ 6, so
    a chunk's cumulative exponents reach ~3700, where fp32's spacing is
    2.4e-4: each fp32 version's decays carry errors the reference sweep's
    4 to 8 heads never reach.  Against fp64 each fp32 version then reads
    1e-5 to 3e-5 of scale (both printed), so the two differ by up to their
    sum, beyond the sweep's 2e-5; a wrong head or chunk gives errors of the
    outputs' own scale."""
    import torch
    from repro_torch.kernels.ssd_scan import (
        ssd_chunk_scan, ssd_chunk_scan_plain, ssd_intra_chunk, ssd_intra_chunk_plain)
    from repro_torch.models.mamba2 import ssd_reference

    gen = torch.Generator(device="cuda").manual_seed(9)
    jamba = (PREFILL_B, PREFILL_S, *JAMBA_SSD)
    mains = [(PREFILL_B, PREFILL_S, 24, 64, 128, 256), jamba]
    cases = [((2, 64, 4, 16, 32, 16), torch.float32), ((2, 128, 8, 32, 64, 32), torch.float32),
             ((2, 256, 8, 64, 128, 64), torch.float32), ((2, 200, 4, 32, 16, 100), torch.float32)]
    cases += [(full, dt) for full in mains for dt in (torch.float32, torch.bfloat16)]
    # The kernel's edges: H not a multiple of its head group (4) and a chunk
    # not a multiple of its 64-position tiles, in both dtypes.
    edges = [((1, 192, 6, 64, 128, 96), torch.float32), ((1, 192, 6, 64, 128, 96), torch.bfloat16),
             ((2, 300, 5, 16, 36, 150), torch.bfloat16), ((1, 320, 7, 32, 64, 160), torch.float32)]
    cases += edges
    main_err = 0.0
    for (B, L, H, P, N, Q), dt in cases:
        args = _ssd_inputs(B, L, H, P, N, dt, gen)
        y, h = ssd_chunk_scan(*args, chunk=Q)
        torch.cuda.synchronize()
        y_want, h_want = ssd_chunk_scan_plain(*args, Q)
        fp32_tol = 1e-4 if (B, L, H, P, N, Q) == jamba else 2e-5
        tol = 2e-2 if dt == torch.bfloat16 else fp32_tol
        ok_y, err_y = _scaled_close(y, y_want, tol)
        ok_h, err_h = _scaled_close(h, h_want, fp32_tol)
        l2 = ""
        if dt == torch.bfloat16:
            del y_want
            y_want, _ = ssd_chunk_scan_plain(*(t.float() for t in args), Q)
            rel = rel_l2(y, y_want)
            ok_y = ok_y and rel <= 1e-2
            l2 = f", y relative L2 against fp32 plain {rel:.3e} (tol 1e-2)"
        say(f"[check] ssd_chunk_scan B={B} L={L} H={H} P={P} N={N} chunk={Q} {str(dt)[6:]}: "
            f"max|kernel-plain| y {err_y:.3e} (tol {tol:g} scaled), state {err_h:.3e} "
            f"(tol {fp32_tol:g} scaled){l2} {'ok' if ok_y and ok_h else 'FAIL'}")
        check(ok_y and ok_h and y.dtype == dt, f"ssd_chunk_scan {(B, L, H, P, N, Q, dt)}")
        if (B, L, H, P, N, Q) == jamba and dt == torch.float32:
            for name, got, plain, exact in zip(("y", "state"), (y, h), (y_want, h_want),
                                               _ssd_fp64(*args, Q)):
                ok, err = _scaled_close(got, exact, fp32_tol)
                err_plain = _scaled_close(plain, exact, fp32_tol)[1]
                scale = max(1.0, exact.abs().max().item())
                say(f"[check]   {name} against the same algorithm in fp64: kernel "
                    f"{err / scale:.3e} of scale (tol {fp32_tol:g}), plain version "
                    f"{err_plain / scale:.3e} {'ok' if ok else 'FAIL'}")
                check(ok, f"ssd_chunk_scan {name} against fp64 at {jamba}")
                del exact
        if (B, L, H, P, N, Q) in mains or ((B, L, H, P, N, Q), dt) in edges:
            errs = []
            alone = ssd_intra_chunk(*args, Q)
            for name, g, w in zip(("y_diag", "states", "a_cs"), alone,
                                  ssd_intra_chunk_plain(*args, Q)):
                ok, err = _scaled_close(g, w, fp32_tol)
                errs.append(err)
                say(f"[check]   kernel alone, {name}: max|kernel-plain|={err:.3e} "
                    f"(tol {fp32_tol:g} scaled) {'ok' if ok else 'FAIL'}")
                check(ok, f"ssd_intra_chunk {name} at {(B, L, H, P, N, Q)} {dt}")
            if (B, L, H, P, N, Q) in mains:
                if dt == torch.bfloat16:
                    main_err = max(main_err, *errs)
                same = all(torch.equal(a, b) for a, b in zip(alone, ssd_intra_chunk(*args, Q)))
                say(f"[check]   kernel alone, a second launch on the same inputs: bit-equal {same}")
                check(same, "ssd_intra_chunk is deterministic")
            del alone
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


def _ssd_fp64(x, dt, A, Bm, Cm, Q: int) -> tuple:
    """(y, final state) of ``ssd_chunked``'s algorithm computed in fp64
    from the same inputs: the exact value both fp32 versions round."""
    import torch

    Bsz, L, H, P = x.shape
    N, n = Bm.shape[-1], L // Q
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    xdt = (x * dt[..., None]).reshape(Bsz, n, Q, H, P)
    Bc, Cc = Bm.reshape(Bsz, n, Q, N), Cm.reshape(Bsz, n, Q, N)
    a_cs = torch.cumsum((dt * A).reshape(Bsz, n, Q, H), 2)            # (B, C, Q, H)
    seg = a_cs.transpose(2, 3)[..., :, None] - a_cs.transpose(2, 3)[..., None, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))      # (B, C, H, Q, Q)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = torch.einsum("bchls,bcshp->bclhp", decay * scores[:, :, None], xdt)
    to_end = xdt * torch.exp(a_cs[:, :, -1:] - a_cs)[..., None]
    states = torch.einsum("bcsn,bcshp->bchpn", Bc, to_end)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float64, device=x.device)
    for c in range(n):
        y[:, c] += torch.einsum("bln,bhpn->blhp", Cc[:, c], h) * torch.exp(a_cs[:, c])[..., None]
        h = h * torch.exp(a_cs[:, c, -1])[..., None, None] + states[:, c]
    return y.reshape(Bsz, L, H, P), h


def phase_zoo_timing():
    """Both kernels at the full-width prefill shapes: kernel, plain version
    and (flash only) ``F.scaled_dot_product_attention`` in alternating
    rounds, beside their bounds.

    flash_attention, olmo-1b: q, k, v (4, 2048, 16, 128) bf16, causal.  The
    products take 2·B·H·D·S·(S+1) flops (each query row meets its i + 1
    keys in two products of 2·D), on the bf16 tensor cores' 989 TFLOP/s;
    the bytes are q, k, v and o read or written once.

    ssd_chunk_scan, mamba2-130m and jamba-1.5-large-398b: the kernel alone
    (the intra-chunk part) on x (4, 2048, 24, 64) and (4, 2048, 256, 64), B,
    C (4, 2048, 128) in bf16, dt fp32, chunk 256 (``_ssd_fwd_row``).
    Its arithmetic is the reference's, in fp32, counted where the decay
    is not zero (s <= l, as the flash count is causal): y Q·(Q+1)·P and
    the state 2·P·N·Q per (b, chunk, head), the scores Q·(Q+1)·N per
    (b, chunk), at 67 TFLOP/s; the bytes are x, B, C, dt read once and
    y, the states and a_cs (fp32) written once.  No single PyTorch call
    computes it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

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

    out["ssd_chunk_scan"] = _ssd_fwd_row("mamba2-130m", PREFILL_B, PREFILL_S, 24, 64, 128, 256,
                                         gen)
    out["ssd_chunk_scan jamba"] = _ssd_fwd_row(JAMBA, PREFILL_B, PREFILL_S, *JAMBA_SSD, gen)
    return out


def _ssd_fwd_row(what: str, B: int, L: int, H: int, P: int, N: int, Q: int, gen) -> dict:
    """The SSD forward kernel alone and its plain version at one bf16
    prefill shape in alternating rounds, beside its bound
    (``phase_zoo_timing``), then the whole scan and plain ``ssd_chunked``."""
    import torch
    from repro_torch.kernels.ssd_scan import (
        ssd_chunk_scan, ssd_chunk_scan_plain, ssd_intra_chunk, ssd_intra_chunk_plain)

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
                     f"ssd_chunk_scan kernel alone, {what} prefill ({B}, {L}, {H}, {P}), N {N}, "
                     f"chunk {Q}, bf16", None)
    scan, _ = alternating({"kernel": lambda: ssd_chunk_scan(*args, chunk=Q),
                           "plain": lambda: ssd_chunk_scan_plain(*args, Q)})
    row["whole_scan_ms"], row["whole_scan_plain_ms"] = scan["kernel"][1], scan["plain"][1]
    say(f"[time] the whole scan (kernel + inter-chunk torch ops) {scan['kernel'][1]:.4f} ms, "
        f"plain ssd_chunked {scan['plain'][1]:.4f} ms")
    del args
    torch.cuda.empty_cache()
    return row


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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy_s, n_kernels, top = _device_busy(prof, 6)
    if not n_kernels:
        say(f"{tag}: traced {what}: the profiler recorded no device time "
            f"(wall {wall * 1e3:.1f} ms)")
        return {"wall_s": wall, "device_busy_s": None}
    say(f"{tag}: traced {what}: wall {wall * 1e3:.1f} ms, device busy {busy_s * 1e3:.1f} ms "
        f"({n_kernels} kernels), idle share {1 - busy_s / wall:.1%}; most device time: "
        + "; ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in top))
    return {"wall_s": wall, "device_busy_s": busy_s, "n_kernels": n_kernels,
            "top_kernels_ms": top}


def _moe_module():
    """``repro_torch.models.moe`` (the module, whose ``route`` the MoE layer
    calls through its globals)."""
    import repro_torch.models.moe  # noqa: F401

    return sys.modules["repro_torch.models.moe"]


class recorded_routing:
    """Within ``with``: every MoE layer's routing, as (expert_idx (T, K),
    keep (T*K,)) in call order, in ``.calls``."""

    def __enter__(self):
        self.mod, self.calls = _moe_module(), []
        self.real = self.mod.route

        def spy(*a, **kw):
            r = self.real(*a, **kw)
            self.calls.append((r.expert_idx, r.keep))
            return r

        self.mod.route = spy
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real
        return False

    def dropped(self) -> int:
        return sum(int((~keep).sum()) for _, keep in self.calls)


def _choices_differ(prefill_calls, serve_calls, batch: int, prompt_len: int) -> float:
    """Share of (token, k) expert choices that differ between a prefill of
    a (batch, prompt_len) prompt and the same prompt served token by token
    (each a token's K experts compared as sorted sets, layer by layer)."""
    import torch

    n_moe = len(prefill_calls)
    pre = torch.stack([idx for idx, _ in prefill_calls]).reshape(n_moe, batch, prompt_len, -1)
    dec = torch.stack([idx for idx, _ in serve_calls[:prompt_len * n_moe]])
    dec = dec.reshape(prompt_len, n_moe, batch, -1).permute(1, 2, 0, 3)
    return (pre.sort(-1).values != dec.sort(-1).values).float().mean().item()


def _timed_prefills(prefill, params, batch) -> tuple:
    """PREFILL_RUNS timed calls of ``prefill(params, batch)`` (host clock
    ending in a synchronize), every kernel's count set to 0 just before
    each and read just after: (times, the counts of each run, the last
    run's logits, the first and last runs' logits bit-equal, peak bytes)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    times, all_launches, first, logits = [], [], None, None
    for _ in range(PREFILL_RUNS):
        logits = None
        zero_counts()
        t0 = time.monotonic()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        all_launches.append(counts())
        if first is None:
            first = logits
    return (times, all_launches, logits, torch.equal(first, logits),
            torch.cuda.max_memory_allocated())


def _prompt_batch(rng, cfg, batch: int, seq: int) -> dict:
    """A (batch, seq) batch of tokens from the numpy generator, and for an
    encoder-decoder the (batch, encoder_seq, d_model) frames after them."""
    import torch

    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).cuda()}
    if cfg.arch_type == "encdec":
        out["frames"] = _frames(rng, batch, cfg)
    return out


def _serve_cache(model, params, batch: dict, max_len: int):
    """The cache the serve driver starts from: None (``generate`` makes the
    empty one) but for an encoder-decoder, whose cross K/V are filled from
    ``decode_forward(..., return_cache=True)`` over the frames' encoding, the
    reference's own source for them (its serve driver decodes against the
    zeroed cross cache ``init_cache`` gives, which no prefill matches)."""
    import torch
    from repro_torch.models import encdec

    cfg = model.cfg
    if cfg.arch_type != "encdec":
        return None
    with torch.no_grad():
        memory = encdec.encode(params, batch["frames"], cfg)
        _, fill = encdec.decode_forward(params, batch["tokens"], memory, cfg, return_cache=True)
    cache = model.init_cache(batch["tokens"].shape[0], max_len, "cuda")
    cache["k_cross"].copy_(fill["k_cross"])
    cache["v_cross"].copy_(fill["v_cross"])
    return cache


def _serve_check(arch: str, dtype: str, prompt_len: int, decode_tokens: int,
                 tol: float, full_prefill: bool, overrides: "dict | None" = None,
                 check_overrides: "dict | None" = None,
                 shape: tuple = (PREFILL_B, PREFILL_S)) -> dict:
    """One zoo model at full width on the card, weights random from seed 0
    (``overrides`` applied to its config, e.g. a cut depth), batches from
    ``numpy.random.default_rng(0)`` (``_prompt_batch``: tokens, and frames
    for an encoder-decoder): ``prefill_step`` on a ``shape`` batch
    (default (4, 2048)), PREFILL_RUNS times after a warm-up
    (``full_prefill``; median and quartiles; the first and last runs'
    logits equal bit for bit) and once more under the profiler (device
    busy time and idle share), then the serve driver (token-by-token
    prefill of a (shape[0], prompt_len) prompt through ``serve_step``,
    then greedy decoding, from ``_serve_cache``), then ``prefill_step`` on
    that prompt, whose logits must agree with the token-by-token ones at
    every prompt position within ``tol`` (relative L2 over the whole
    tensor).  Both runs of that check use the config with
    ``check_overrides`` (an MoE model's capacity factor at which its
    prefill drops nothing, as decoding one token never does).  Every
    kernel's count is set to 0 just before each run and read just after:
    a prefill (and a cache fill) launches the kernels ``_launches`` gives,
    and decode none.  For an MoE model the warm-up prefill
    counts its dropped assignments, and the check prints the share of
    expert choices that differ between its two runs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(arch).with_overrides(dtype=dtype, param_dtype=dtype, **(overrides or {}))
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    init_peak = torch.cuda.max_memory_allocated()
    n_params = model.param_count(params)
    prefill = make_prefill_step(model)
    per_prefill = _launches(cfg)
    only = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(0)
    moe = cfg.n_experts > 0
    B, S = shape
    out = {"arch": arch, "dtype": dtype, "params": n_params, "n_layers": cfg.n_layers,
           "init_peak_bytes": init_peak}
    tag = f"[zoo] {arch} {dtype}" + (f" ({overrides})" if overrides else "")
    say(f"{tag}: {n_params:,} params, {sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f} GB; "
        f"max_memory_allocated at init {init_peak / 2**30:.2f} GiB")

    if full_prefill:
        batch = _prompt_batch(rng, cfg, B, S)
        over = (f" over {tuple(batch['frames'].shape)} frames" if "frames" in batch else "")
        with recorded_routing() as rec:   # warm-up: cuBLAS and the kernels' first load
            prefill(params, batch)
        torch.cuda.synchronize()
        if moe:
            capacity = _moe_module().capacity_for(cfg, B * S, cfg.moe_capacity_factor)
            n_assign = len(rec.calls) * B * S * cfg.top_k
            out.update(dropped=rec.dropped(), assignments=n_assign, capacity=capacity)
            say(f"{tag}: prefill ({B}, {S}) at capacity factor "
                f"{cfg.moe_capacity_factor}: capacity {capacity} slots an expert, buffers "
                f"({cfg.n_experts}, {capacity}, {cfg.d_model}); dropped {out['dropped']:,} of "
                f"{n_assign:,} assignments ({out['dropped'] / n_assign:.3%}) over "
                f"{len(rec.calls)} MoE layers")
        del rec
        times, all_launches, logits, bit_equal, peak = _timed_prefills(prefill, params, batch)
        launches = all_launches[-1]
        finite = bool(torch.isfinite(logits).all())
        q1, med, q3 = quartiles(times)
        say(f"{tag}: prefill_step on ({B}, {S}){over} median "
            f"{med * 1e3:.1f} ms, quartiles {q1 * 1e3:.1f}-{q3 * 1e3:.1f} ms over {PREFILL_RUNS} "
            f"runs (each {', '.join(f'{t * 1e3:.1f}' for t in times)}), logits "
            f"{tuple(logits.shape)} {str(logits.dtype)[6:]} finite={finite}; first and last "
            f"runs' logits bit-equal: {bit_equal}; launches a run "
            f"{launches}; max_memory_allocated {peak / 2**30:.2f} GiB")
        check(tuple(logits.shape) == (B, S, cfg.vocab_size)
              and logits.dtype == torch.float32 and finite, f"{arch} prefill logits")
        check(all(n == only | per_prefill for n in all_launches),
              f"{arch} prefill: exactly {per_prefill} launches a run, got {all_launches}")
        check(bit_equal, f"{arch}: two prefills of the same batch are bit-equal")
        out.update(prefill_s=med, prefill_s_quartiles=(q1, med, q3), prefill_s_runs=times,
                   prefill_launches=launches, prefill_peak_bytes=peak,
                   prefill_bit_equal=bit_equal)
        zero_counts()
        out["prefill_trace"] = _trace_prefill(lambda: prefill(params, batch), tag)
        check(counts() == only | per_prefill, f"{arch} traced prefill launches")
        del logits, batch

    if check_overrides:
        cfg = cfg.with_overrides(**check_overrides)
        model = get_model(cfg)
        prefill = make_prefill_step(model)
        say(f"{tag}: the serving check runs with {check_overrides}")
    prompt = _prompt_batch(rng, cfg, B, prompt_len)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    cache = _serve_cache(model, params, prompt, prompt_len + decode_tokens)
    fill_launches = counts()
    check(fill_launches == (only if cache is None else only | per_prefill),
          f"{arch} serve cache fill launches {fill_launches}")
    zero_counts()
    with recorded_routing() as served:
        res = generate(model, params, prompt["tokens"], decode_tokens, keep_prompt_logits=True,
                       cache=cache)
    serve_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    ms_tok = res.decode_s / max(decode_tokens - 1, 1) * 1e3
    filled = "" if cache is None else (
        f" from the cross cache decode_forward(return_cache=True) fills (launches "
        f"{fill_launches})")
    say(f"{tag}: serve driver, ({B}, {prompt_len}) prompt token by token in "
        f"{res.prefill_s:.3f} s{filled}, {decode_tokens} tokens decoded at {ms_tok:.2f} ms/token; "
        f"launches {serve_launches}; first sequence {res.tokens[0].tolist()}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(serve_launches == only, f"{arch} serve: no kernel launch, got {serve_launches}")
    check(tuple(res.tokens.shape) == (B, decode_tokens)
          and bool(torch.isfinite(res.last_logits).all()), f"{arch} serve output")
    if moe:
        check(not served.dropped(), f"{arch}: token-by-token serving drops no assignment")
    del cache

    zero_counts()
    with recorded_routing() as pre:
        logits = prefill(params, prompt)
    launches = counts()
    err = rel_l2(logits, res.prompt_logits)
    max_abs = (logits - res.prompt_logits).abs().max().item()
    agree = (logits.argmax(-1) == res.prompt_logits.argmax(-1)).float().mean().item()
    routing = ""
    if moe:
        out["prompt_dropped"] = pre.dropped()
        out["choices_differ"] = _choices_differ(pre.calls, served.calls, B, prompt_len)
        routing = (f"; expert choices that differ {out['choices_differ']:.4%}, prefill "
                   f"dropped {out['prompt_dropped']}")
        check(out["prompt_dropped"] == 0, f"{arch}: the check's prefill drops nothing")
    say(f"{tag}: prefill_step on that prompt vs its token-by-token logits: relative L2 "
        f"{err:.3e} (tol {tol:g}), max|diff| {max_abs:.3e} (max|logit| "
        f"{logits.abs().max().item():.3f}), argmax agreement {agree:.4f}; launches {launches}"
        + routing)
    check(launches == only | per_prefill, f"{arch} prompt prefill launches")
    check(err <= tol, f"{arch} {dtype} prefill agrees with token-by-token serving within {tol}")
    out.update(serve_prefill_s=res.prefill_s, decode_ms_per_token=ms_tok,
               serve_launches=serve_launches, prompt_prefill_launches=launches,
               serve_peak_bytes=peak,
               prefill_vs_serve_rel_l2=err, prefill_vs_serve_max_abs=max_abs,
               argmax_agreement=agree, tokens_first_sequence=res.tokens[0].tolist())
    del params, logits, res, served, pre, prompt
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
    out["olmo-1b bf16"] = _serve_check("olmo-1b", "bfloat16", 32, 16, 5e-2, True)
    out["mamba2-130m bf16"] = _serve_check("mamba2-130m", "bfloat16", 256, 16, 0.5, True)
    out["olmo-1b fp32"] = _serve_check("olmo-1b", "float32", 32, 2, 1e-3, False)
    out["mamba2-130m fp32"] = _serve_check("mamba2-130m", "float32", 256, 2, 1e-3, False)
    return out


def _frames(rng, batch: int, cfg, device="cuda"):
    """(batch, encoder_seq, d_model) stub frame embeddings, N(0, 1) from the
    numpy generator, in the activation dtype (as the trainer draws them)."""
    import torch

    return torch.from_numpy(rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model))).to(
        device, cfg.activation_dtype)


def _launches(cfg, backward: bool = False) -> dict:
    """Kernel launches of one prefill (with ``backward``: the backward
    launches of one train step), by kernel: ``flash_attention`` once an
    attention (for an encoder-decoder the encoder's layers plus two a
    decoder layer, self and cross) and ``ssd_chunk_scan`` once a Mamba layer
    (every layer of an SSM; in a hybrid every layer but one in each
    ``attn_period``)."""
    n_attn, n_ssd = cfg.n_layers, 0
    if cfg.arch_type == "encdec":
        n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    elif cfg.arch_type == "ssm":
        n_attn, n_ssd = 0, cfg.n_layers
    elif cfg.arch_type == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_period
        n_ssd = cfg.n_layers - n_attn
    names = (("flash_attention_bwd", "ssd_intra_chunk_bwd") if backward
             else ("flash_attention", "ssd_chunk_scan"))
    return {k: n for k, n in zip(names, (n_attn, n_ssd)) if n}


def phase_encdec_paths():
    """whisper-small's serve path at full width and depth (``_serve_check``):
    in bf16 (the config's dtype) with the timed and traced (8, 448) prefill
    over (8, 1500, 768) frames (36 flash launches: 12 encoder, 12 decoder
    self, 12 cross) and the serve driver on an (8, 32) prompt from the
    filled cross cache (``_serve_cache``), then the prefill-against-serving
    check again in fp32.  Tolerances as for the other families
    (``phase_zoo_paths``): 5e-2 in bf16, 1e-3 in fp32."""
    shape = (WHISPER_B, WHISPER_S)
    return {"whisper-small bf16": _serve_check("whisper-small", "bfloat16", 32, 16, 5e-2, True,
                                               shape=shape),
            "whisper-small fp32": _serve_check("whisper-small", "float32", 32, 2, 1e-3, False,
                                               shape=shape)}


def _drop_free(arch: str, overrides: "dict | None" = None) -> dict:
    """The capacity factor E/K (of the config with ``overrides``), at which
    capacity >= T: an MoE prefill then drops nothing, as token-by-token
    decoding never does."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).with_overrides(**(overrides or {}))
    return {"moe_capacity_factor": cfg.n_experts / cfg.top_k}


def phase_moe_paths():
    """The MoE serve path at full width (``_serve_check``): granite-moe-
    1b-a400m (24 layers, 16 query over 8 KV heads of 64, 32 experts top 8)
    and deepseek-moe-16b at full depth (28 layers, the first dense, 16 x
    128 MHA, 2 shared + 64 routed experts top 6) in bf16, each with the
    (4, 2048) prefill at the configs' capacity factor 1.25 (24 and 28
    flash launches, dropped assignments counted) and the serve driver;
    then the prefill-against-serving check in fp32, granite at full depth
    and deepseek-moe-16b cut to 2 layers (the dense one and one MoE: its
    whole fp32 model would be 65 GB).  The checks run at capacity factor
    E/K (``_drop_free``).

    Tolerances (relative L2 over all logits): fp32 1e-3, as for the other
    families.  bf16: MOE_BF16_TOL, 0.2; the two paths round differently
    (see ``phase_zoo_paths``), and where a token's router is near a tie
    between its k-th and (k+1)-th expert, that rounding can move it to
    another expert in one path, which changes the token's expert output
    by a whole gated expert row from that layer on.  Random routers are
    near uniform, so near ties are common: an H100 run read 2.5e-2
    for granite (3.8 % of expert choices differ) and 6.8e-2 for
    deepseek-moe-16b (10.0 %), so the limit is 3x the larger; a wrong
    dispatch or combine moves the logits by O(1).  The share of choices
    that differ is printed.  The fp32 checks hold the MoE path tightly."""
    out = {}
    for arch, decode in (("granite-moe-1b-a400m", 16), ("deepseek-moe-16b", 4)):
        out[f"{arch} bf16"] = _serve_check(arch, "bfloat16", 32, decode, MOE_BF16_TOL, True,
                                           check_overrides=_drop_free(arch))
    out["granite-moe-1b-a400m fp32"] = _serve_check(
        "granite-moe-1b-a400m", "float32", 32, 2, 1e-3, False,
        check_overrides=_drop_free("granite-moe-1b-a400m"))
    out["deepseek-moe-16b fp32"] = _serve_check(
        "deepseek-moe-16b", "float32", 32, 2, 1e-3, False,
        overrides={"n_layers": 2}, check_overrides=_drop_free("deepseek-moe-16b"))
    return out


def phase_hybrid_paths():
    """jamba-1.5-large-398b's serve path (``_serve_check``) at full width
    and one superblock: in bf16 at the serving cut (``JAMBA_SERVE_CUT``),
    the (4, 2048) prefill (1 flash and 7 SSD scan launches) timed and
    traced, the serve driver on a (4, 256) prompt (a whole SSD chunk, which
    the prefill needs), and the prefill-against-serving check at capacity
    factor E/K = 2; then that check in fp32 at the training cut
    (``JAMBA_TRAIN_CUT``, 23.1 GB; the serving cut in fp32 would be 64.6
    GB).  First no earlier model may still hold the card's memory.

    Tolerances (relative L2 over all logits): fp32 1e-3, as for the other
    families.  bf16: JAMBA_BF16_TOL, 0.5, mamba2-130m's, which catches only
    gross faults: the two paths round differently in bf16 (see
    ``phase_zoo_paths``), seven of the eight layers are Mamba layers, whose
    plain bf16 prefill against their plain bf16 decode already read 0.197
    through mamba2-130m's 24 layers, and the MoE layers' near ties can send
    a token to another expert in one path (``phase_moe_paths``).  The fp32
    check holds the path tightly."""
    import torch

    held = torch.cuda.memory_allocated()
    say(f"[zoo] {JAMBA}: memory_allocated before its weights {held / 2**30:.2f} GiB")
    check(held < 2**30, "no earlier model holds the card's memory")
    return {
        f"{JAMBA} bf16": _serve_check(JAMBA, "bfloat16", JAMBA_SSD[3], 8, JAMBA_BF16_TOL, True,
                                      overrides=JAMBA_SERVE_CUT,
                                      check_overrides=_drop_free(JAMBA, JAMBA_SERVE_CUT)),
        f"{JAMBA} fp32": _serve_check(JAMBA, "float32", JAMBA_SSD[3], 2, 1e-3, False,
                                      overrides=JAMBA_TRAIN_CUT,
                                      check_overrides=_drop_free(JAMBA, JAMBA_TRAIN_CUT)),
    }


def phase_zoo_reference_check():
    """Reduced olmo-1b, mamba2-130m, granite-moe-1b-a400m,
    deepseek-moe-16b, whisper-small and jamba-1.5-large-398b (2 layers: a
    Mamba layer and an attention layer with 4 experts) in fp32 from the
    same weights on the
    card (kernels) and on the CPU (plain versions): prefill logits on a
    (2, 64) batch (whisper's over (2, 16, 256) frames) within 1e-4 (abs
    and rel; fp32 summed in other orders, the CPU parity tests'
    tolerance), the serve driver's greedy tokens equal, and for the MoE
    models every layer's expert choices and keep mask equal (at the
    configs' capacity factor, where this batch drops assignments).  For
    jamba the absolute part is 1e-4 of the logits' scale, max(1,
    max|logits|): its Mamba layer's output, as large as the residual
    stream, reaches the logits (up to ~5) through one more layer, and the
    SSD scan's fp32 sums carry errors in proportion to their largest terms
    (``_scaled_close``); mamba2-130m's reduced logits stay below 1.5."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_map

    out = {}
    for arch in ("olmo-1b", "mamba2-130m", "granite-moe-1b-a400m", "deepseek-moe-16b",
                 "whisper-small", JAMBA):
        cfg = get_config(arch).reduced().with_overrides(dtype="float32", param_dtype="float32")
        model = get_model(cfg)
        params = model.init(torch.Generator().manual_seed(3), "cpu")
        rng = np.random.default_rng(4)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))}
        if cfg.arch_type == "encdec":
            batch["frames"] = _frames(rng, 2, cfg, "cpu")
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
        runs = {}
        for device in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(device), params)
            zero_counts()
            with recorded_routing() as rec:
                logits = make_prefill_step(model)(p, tree_map(lambda t: t.to(device), batch))
            toks = generate(model, p, prompt.to(device), 6).tokens
            runs[device] = (logits.cpu(), toks.cpu(), counts(),
                            [(i.cpu(), k.cpu()) for i, k in rec.calls])
        (cl, ct, cn, cr), (pl, pt, pn, pr) = runs["cuda"], runs["cpu"]
        err = (cl - pl).abs().max().item()
        scale = max(1.0, pl.abs().max().item()) if cfg.arch_type == "hybrid" else 1.0
        ok = torch.allclose(cl, pl, atol=1e-4 * scale, rtol=1e-4)
        same = torch.equal(ct, pt)
        routing = ""
        if cfg.n_experts:
            same_route = len(cr) == len(pr) > 0 and all(
                torch.equal(a, b) and torch.equal(ka, kb) for (a, ka), (b, kb) in zip(cr, pr))
            drops = sum(int((~k).sum()) for _, k in pr)
            routing = (f"; expert choices and keep masks equal in {len(pr)} MoE layers: "
                       f"{same_route} ({drops} assignments dropped)")
            same = same and same_route
            out[arch + " routing_equal"] = same_route
        say(f"[reference] reduced {arch} fp32, card against CPU: max|logits diff| {err:.3e} "
            f"(tol 1e-4 abs+rel{f', abs times {scale:.3f}' if scale != 1.0 else ''}), "
            f"relative L2 {rel_l2(cl, pl):.3e} {'ok' if ok else 'FAIL'}; greedy tokens equal: "
            f"{torch.equal(ct, pt)}; launches card {_nonzero(cn)}, cpu {_nonzero(pn)}" + routing)
        check(ok and same, f"reduced {arch}: card agrees with the CPU")
        only = dict.fromkeys(KERNELS, 0)
        check(cn == only | _launches(cfg) and pn == only, f"{arch}: the card run launched each "
              f"kernel once an attention or a Mamba layer (an encoder-decoder's decoder layer "
              f"twice), the CPU run none")
        out[arch] = {"max_logits_diff": err, "tokens_equal": torch.equal(ct, pt)}
    return out


# ---------------------------------------------------------------------------
# Training the zoo and federated LoRA: flash_attention_bwd
# ---------------------------------------------------------------------------

def _flash_module():
    """The flash wrapper module (the package re-exports its function under
    the module's name, so ``import ... as`` would give the function)."""
    import repro_torch.kernels.flash_attention  # noqa: F401

    return sys.modules["repro_torch.kernels.flash_attention"]


def _lse_err(got, want) -> float:
    """max |got - want| of two log-sum-exps, a row with no key in range
    (+inf in both) counting 0; NaN anywhere in ``got`` gives NaN."""
    import torch

    return torch.where(got == want, 0.0, (got - want).abs()).max().item()


def phase_flash_bwd_check():
    """The backward kernel against ``flash_attention_bwd_plain`` computed in
    fp32 from the same inputs (the forward kernel's output and log-sum-exp,
    the same dO): the main paths' calls, olmo-1b's shape (4, 2048, 16, 128),
    granite-moe-1b-a400m's (4, 2048, 16 query heads over 8 KV heads of
    64), jamba-1.5-large-398b's train step (1, 2048, 64 query heads over 8
    KV heads of 128: the dK / dV kernel sums 8 query heads), causal bf16,
    and whisper-small's three (``WHISPER_ATTN``: the
    encoder's (8, 1500 x 1500, 12, 64) and the cross-attention's (8, 448
    queries over 1500 keys), full, and the decoder's (8, 448 x 448)
    causal), bf16, each also relaunched and held bit-equal; then GQA (32 query heads on 8, and
    8:1), D 64, a window across tiles and one narrower than a 64-row tile,
    full attention, ragged S (1000, 130 and 1) and S at the bf16 kernels'
    tile edges (63, 64, 65, 127, 128, 129), keys longer or shorter than
    the queries (``_two_length_cases`` in bf16 and fp32), the fp32 path,
    and a q whose base is off 16 bytes.  bf16: relative L2 <= 1e-2 per
    gradient; fp32: within 2e-5 of each gradient's max |.|.  With one key,
    dq and dk are 0 in exact arithmetic (P = 1 and dP = Delta), so they are
    held within 1e-2 (bf16) / 2e-5 (fp32) of max|dv| instead.  The
    forward's log-sum-exp is held against ``attention_lse_plain`` within
    2e-5 of its scale (+inf in both for a row with no key in range), and
    the forward's output with the log-sum-exp stored must equal the output
    without it bit for bit.  Returns the largest |kernel - plain| over the
    three gradients at the main paths' shapes."""
    import torch

    fa = _flash_module()
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    main_cases = [(PREFILL_B, PREFILL_S, 16, 16, 128, True, None, bf),
                  (PREFILL_B, PREFILL_S, 16, 8, 64, True, None, bf),
                  (1, PREFILL_S, *JAMBA_ATTN, True, None, bf)]
    cases = [*main_cases,
             (2, 1024, 32, 8, 128, True, None, bf),     # GQA 4:1
             (2, 512, 8, 8, 64, True, None, bf),        # D 64
             (1, 1000, 8, 2, 128, True, 200, bf),       # a window across tiles
             (2, 300, 4, 4, 128, False, None, bf),      # full attention, ragged S
             (1, 1000, 4, 1, 64, True, None, bf),       # ragged S, MQA
             (2, 130, 4, 2, 128, True, None, bf),
             (1, 1, 4, 2, 128, True, None, bf),         # one position
             # the bf16 kernels' tile edges: 64-row query tiles and 128-key
             # blocks (dK / dV), 128-row query blocks and 128-key tiles (dQ)
             (1, 63, 4, 4, 64, True, None, bf),
             (2, 64, 8, 1, 128, True, None, bf),        # GQA 8:1
             (1, 65, 4, 4, 128, True, None, bf),
             (2, 127, 8, 1, 64, True, None, bf),
             (1, 128, 4, 2, 128, True, None, bf),
             (2, 129, 16, 2, 64, True, 16, bf),         # a window narrower than a tile
             (1, 2048, 16, 2, 128, True, 40, bf),
             (2, 300, 8, 2, 64, True, None, f32),       # the fp32 path
             (1, 1000, 4, 2, 128, True, 100, f32),
             (2, 130, 4, 4, 128, False, None, f32),
             (1, 1, 4, 4, 64, True, None, f32)]
    cases = [c[:2] + c[1:] for c in cases]   # Sk = S
    main_cases = [c[:2] + c[1:] for c in main_cases]
    main_cases += [c + (None, bf) for c in WHISPER_ATTN.values()]
    cases = main_cases + cases[3:] + _two_length_cases(bf) + _two_length_cases(f32)
    main_err = 0.0
    for case in cases:
        B, S, Sk, H, KV, D, causal, window, dt = case
        q, k, v = _qkv(B, S, H, KV, D, dt, gen, Sk)
        dout = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        o = fa._launch(q, k, v, causal, window, lse=lse)
        o_plain_fwd = fa._launch(q, k, v, causal, window)
        got = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal, window=window)
        torch.cuda.synchronize()
        lse_want = fa.attention_lse_plain(q.float(), k.float(), causal, window)
        lse_err = _lse_err(lse, lse_want)
        finite = torch.isfinite(lse_want)
        ok = torch.equal(o, o_plain_fwd) and lse_err <= 2e-5 * max(
            1.0, lse_want[finite].abs().max().item() if finite.any() else 0.0)
        want = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            dout.float(), causal, window)
        tol = 1e-2 if dt == bf else 2e-5
        errs, scores = [], []
        dv_scale = want[2].abs().max().item()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            ok = ok and g.dtype == dt and g.shape == w.shape and bool(torch.isfinite(g).all())
            err = (g.float() - w).abs().max().item()
            errs.append(err)
            if Sk == 1 and name != "dv":
                score = err / dv_scale
            elif dt == bf:
                score = rel_l2(g, w)
            else:
                score = err / max(1.0, w.abs().max().item())
            scores.append(score)
            ok = ok and score <= tol
        measure = ("max|.|/max|dv|" if Sk == 1 else
                   "relative L2" if dt == bf else "max|kernel-plain|/max(1,max|plain|)")
        lengths = f"S={S}" if Sk == S else f"Sq={S} Sk={Sk}"
        say(f"[check] flash_attention_bwd B={B} {lengths} H={H} KV={KV} D={D} "
            f"{'causal' if causal else 'full'} window={window} {str(dt)[6:]}: {measure} "
            + ", ".join(f"{n} {x:.3e}" for n, x in zip(("dq", "dk", "dv"), scores))
            + f" (tol {tol:g}); lse max|diff| {lse_err:.3e}; output with lse stored "
            f"bit-equal {torch.equal(o, o_plain_fwd)} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash_attention_bwd {case}")
        if case in main_cases:
            main_err = max(main_err, *errs)
            again = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal, window=window)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            say(f"[check] flash_attention_bwd at {case[:6]}, a second launch on the same "
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
    forward, each timed in the same rounds), beside its bound; the device
    time of each of its two kernels (dQ, then dK / dV) and of SDPA's
    gradient from five calls under ``torch.profiler`` (the timed call of
    the kernel also counts the wrapper's host time before its first
    launch, which SDPA's difference of two timed calls cancels); then the
    forward with and without the log-sum-exp store.

    The needed work is the five products S, dP, dV, dK and dQ, 2.5 times
    the forward's 2·B·H·D·S·(S+1) (causal), on the bf16 tensor cores' 989
    TFLOP/s; the dQ kernel's recompute of S and dP is not counted.  The bytes
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
    ours = _device_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout))
    lib_dev = sum(_device_ms(sdpa_fwd_bwd).values()) - sum(_device_ms(sdpa_fwd).values())
    split = {name: sum(t for n, t in ours.items() if name in n)
             for name in ("bwd_dq_wgmma", "bwd_dkdv_wgmma")}
    row["device_ms_by_kernel"] = split
    row["device_ms"], row["library_device_ms"] = sum(ours.values()), lib_dev
    if not ours or lib_dev <= 0:
        say("[time] flash_attention_bwd: the profiler recorded no device time")
    else:
        say(f"[time] flash_attention_bwd device time a call by kernel (torch.profiler, 5 calls): "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in split.items())
            + f"; all its kernels {sum(ours.values()):.4f} ms against the {row['ms']:.4f} ms "
            f"timed call (the rest is the wrapper's host time before the first launch); SDPA's "
            f"gradient on the device {lib_dev:.4f} ms, so {sum(ours.values()) / lib_dev:.2f}x it")
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


def _flash_shape_timing(what: str, B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
                        causal: bool, gen) -> dict:
    """Both flash kernels at one attention shape, bf16: q (B, Sq, H, D) over
    k, v (B, Sk, KV, D).  Forward: kernel, plain version and
    ``F.scaled_dot_product_attention`` (``enable_gqa`` where KV < H);
    backward: kernel, plain version and SDPA's forward + backward less its
    forward, each in alternating rounds.  Bounds: the forward's two
    products, 2·B·H·D·S·(S+1) flops causal (Sq = Sk = S) and 4·B·H·D·Sq·Sk
    full (H the query heads), the backward's five 2.5 times that, on the
    bf16 tensor cores' 989 TFLOP/s; bytes q, k, v, o (and dO, the
    log-sum-exp, dq, dk, dv for the backward) read or written once."""
    import torch
    import torch.nn.functional as F

    fa = _flash_module()
    q, k, v = _qkv(B, Sq, H, KV, D, torch.bfloat16, gen, Sk)
    lengths = f"{Sq}" if Sq == Sk else f"{Sq} q / {Sk} k"
    heads = f"{H}" if KV == H else f"{H} q / {KV} KV heads"
    what = f"{what} ({B}, {lengths}, {heads}, {D}) bf16 {'causal' if causal else 'full'}"
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=KV != H)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa()

    q4, n = alternating({"kernel": lambda: fa.flash_attention(q, k, v, causal=causal),
                         "plain": lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                         "library": sdpa_fwd})
    fwd_flops = 2 * B * H * D * Sq * (Sq + 1) if causal else 4 * B * H * D * Sq * Sk
    q_bytes, kv_bytes = B * Sq * H * D * 2, B * Sk * KV * D * 2
    library = f"F.scaled_dot_product_attention(is_causal={causal}, enable_gqa={KV != H})"
    fwd = _bound_row(q4, n, fwd_flops, BF16_FLOPS_PER_S, 2 * q_bytes + 2 * kv_bytes,
                     f"flash_attention {what}", library)

    dout = torch.randn((B, Sq, H, D), generator=gen, device="cuda").bfloat16()
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    o = fa._launch(q, k, v, causal, None, lse=lse)
    dot = dout.transpose(1, 2)

    def sdpa_fwd_bwd():
        qt.grad = kt.grad = vt.grad = None
        sdpa().backward(dot)

    q4, n = alternating({
        "kernel": lambda: fa.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal),
        "plain": lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, dout, causal=causal),
        "library": sdpa_fwd_bwd,
        "library_fwd": sdpa_fwd,
    })
    lib = q4["library"][1] - q4["library_fwd"][1]
    bwd = _bound_row(q4, n, 2.5 * fwd_flops, BF16_FLOPS_PER_S,
                     4 * q_bytes + 4 * kv_bytes + B * H * Sq * 4,
                     f"flash_attention_bwd {what}", f"{library} forward + backward")
    bwd["library_ms"], bwd["library_fwd_ms"] = lib, q4["library_fwd"][1]
    say(f"[time] {what}: the forward is {fwd['ms'] / fwd['library_ms']:.2f}x SDPA; SDPA's "
        f"gradient alone (forward + backward {q4['library'][1]:.4f} ms minus its forward "
        f"{q4['library_fwd'][1]:.4f} ms) {lib:.4f} ms, the backward kernel {bwd['ms'] / lib:.2f}x it")
    del q, k, v, o, dout, lse, qt, kt, vt
    torch.cuda.empty_cache()
    return {"forward": fwd, "backward": bwd}


def phase_flash_shape_timing():
    """Both flash kernels (``_flash_shape_timing``) at granite-moe-1b-a400m's
    attention, q (4, 2048, 16, 64) over k, v (4, 2048, 8, 64), causal (GQA
    2:1 at head width 64), at jamba-1.5-large-398b's, q (B, 2048, 64, 128)
    over k, v (B, 2048, 8, 128), causal (GQA 8:1), at its prefill's B 4 and
    its train step's B 1, and at whisper-small's two full-attention shapes
    (``WHISPER_ATTN``): the encoder's (8, 1500 x 1500, 12, 64) and the
    decoder's cross-attention, 448 queries over 1500 keys."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {"granite-moe-1b-a400m": _flash_shape_timing(
        "granite-moe-1b-a400m", PREFILL_B, PREFILL_S, PREFILL_S, 16, 8, 64, True, gen)}
    for B, name in ((PREFILL_B, "prefill"), (1, "train")):
        out[f"{JAMBA} {name}"] = _flash_shape_timing(f"{JAMBA} {name}", B, PREFILL_S, PREFILL_S,
                                                    *JAMBA_ATTN, True, gen)
    for name in ("encoder", "cross"):
        out[f"whisper-small {name}"] = _flash_shape_timing(f"whisper-small {name}",
                                                           *WHISPER_ATTN[name], gen)
    return out


def _device_ms(fn, n: int = 5) -> dict:
    """Device time (ms) a call of ``fn`` by kernel name, from ``n`` calls
    under ``torch.profiler``: free of the host time that the event timing
    of one call counts before its first launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return {name: t / n / 1e3 for name, t in by_name.items()}


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
    adapters on wq, wk, wv and wo, fp32 factors), its depth cut to
    LORA_LAYERS of its 16 layers to keep the script's time, LORA_SILOS
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

    cfg = get_config("olmo-1b").with_overrides(n_layers=LORA_LAYERS).with_lora(2)
    silos = make_lm_silos(LORA_SILOS, cfg.vocab_size, TRAIN_S, [(4, 2)] * LORA_SILOS, seed=0)
    model, params0, clients = _lora_setup(cfg, "cuda", 0, 1, silos, make_optimizer_for)
    leaves0 = [(keystr(p), t.clone()) for p, t in tree_flatten_with_path(params0)[0]]
    n_adapter = sum(t.numel() for k, t in leaves0 if ".lora_" in k)
    n_total = sum(t.numel() for _, t in leaves0)
    tag = f"[lora] olmo-1b bf16 rank 2 ({cfg.n_layers} layers)"
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


def _train_step_card_vs_cpu(arch: str, per_leaf: bool) -> dict:
    """One reduced fp32 ``make_train_step`` step of ``arch`` on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batch: the loss within 1e-4, every leaf's gradient within 1e-4
    relative L2, and the forward and backward kernels launched as
    ``_launches`` says on the card, never on the CPU.  The updated parameters within 1e-4 relative L2, leaf by leaf
    where ``per_leaf``, else as one vector (the worst leaf is printed).
    AdamW's first step moves an element by about lr whatever its
    gradient's size, so an element whose gradient is near AdamW's eps
    moves by an amount its gradient's last bits decide: in a leaf that
    starts at zero (mamba2's ``conv_b``) such elements are a visible share
    of the leaf's norm, though the gradients agree."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_optimizer_for, make_train_step
    from repro_torch.models import get_model
    from repro_torch.utils.tree import (
        keystr, tree_flatten, tree_flatten_with_path, tree_map, tree_unflatten)

    cfg = get_config(arch).reduced().with_overrides(dtype="float32", param_dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    names = [keystr(k) for k, _ in tree_flatten_with_path(params)[0]]
    seq = 64   # a multiple of the reduced configs' SSD chunk (32)
    rng = np.random.default_rng(1)
    batch = _lm_batch(SyntheticLM(cfg.vocab_size, seq, seed=1), rng, 2)
    if cfg.arch_type == "encdec":
        batch["frames"] = _frames(rng, 2, cfg)
    runs = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), params)
        b = tree_map(lambda t: t.to(device), batch)
        leaves, treedef = tree_flatten(p)
        live = [t.detach().requires_grad_(True) for t in leaves]
        grads = torch.autograd.grad(model.loss(tree_unflatten(treedef, live), b), live)
        opt = make_optimizer_for(cfg)
        zero_counts()
        new, _, loss = make_train_step(model, opt)(p, opt.init(p), b)
        runs[device] = ([t.cpu() for t in tree_flatten(new)[0]], [g.cpu() for g in grads],
                        float(loss), counts())
    (cp, cg, cl, cn), (pp, pg, pl, pn) = runs["cuda"], runs["cpu"]

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    leaf_rel = [rel(a, b) for a, b in zip(cp, pp)]
    worst_grad = max(rel(a, b) for a, b in zip(cg, pg))
    whole = rel(torch.cat([t.reshape(-1) for t in cp]), torch.cat([t.reshape(-1) for t in pp]))
    worst_i = max(range(len(leaf_rel)), key=leaf_rel.__getitem__)
    params_ok = max(leaf_rel) <= 1e-4 if per_leaf else whole <= 1e-4
    ok = abs(cl - pl) <= 1e-4 * max(1.0, abs(pl)) and worst_grad <= 1e-4 and params_ok
    say(f"[reference] reduced {arch} fp32 train step (batch 2, seq {seq}), card against CPU: "
        f"loss {cl:.6f} / {pl:.6f}, worst leaf gradient relative L2 {worst_grad:.3e} (tol 1e-4); "
        f"updated parameters relative L2: whole model {whole:.3e}, worst leaf {leaf_rel[worst_i]:.3e} "
        f"({names[worst_i]}) (tol 1e-4 {'per leaf' if per_leaf else 'for the whole model'}); "
        f"launches card {_nonzero(cn)}, cpu {_nonzero(pn)} {'ok' if ok else 'FAIL'}")
    only = dict.fromkeys(KERNELS, 0)
    check(ok and cn == only | _launches(cfg) | _launches(cfg, True) and pn == only,
          f"reduced {arch} train step: card agrees with the CPU")
    return {"loss": (cl, pl), "worst_rel_l2": max(leaf_rel), "worst_leaf": names[worst_i],
            "whole_rel_l2": whole, "worst_grad_rel_l2": worst_grad, "launches": _nonzero(cn)}


def phase_train_reference_check():
    """Reduced olmo-1b, mamba2-130m, granite-moe-1b-a400m,
    deepseek-moe-16b, whisper-small and jamba-1.5-large-398b in fp32 on the
    card (kernels) and on the CPU (plain versions) from the same weights:
    one train step each (``_train_step_card_vs_cpu``; updated parameters
    held leaf by leaf, but mamba2-130m's and jamba's, which start with zero
    biases (and jamba's AdamW keeps bf16 moments), as one vector), and
    one federated LoRA round of olmo-1b
    (``with_lora(2)``, 2 silos, uncompressed, fold cost fixed so the
    trace's times are arithmetic): adapters within 1e-4, base leaves
    bit-equal, event traces equal."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_silos
    from repro_torch.federated import AsyncFLServer
    from repro_torch.launch.steps import make_optimizer_for
    from repro_torch.models.fl_models import lora_adapter_schema
    from repro_torch.utils.tree import keystr, tree_flatten_with_path

    olmo = _train_step_card_vs_cpu("olmo-1b", per_leaf=True)
    mamba = _train_step_card_vs_cpu("mamba2-130m", per_leaf=False)
    moe = {arch: _train_step_card_vs_cpu(arch, per_leaf=True)
           for arch in ("granite-moe-1b-a400m", "deepseek-moe-16b")}
    whisper = _train_step_card_vs_cpu("whisper-small", per_leaf=True)
    jamba = _train_step_card_vs_cpu(JAMBA, per_leaf=False)
    cfg = get_config("olmo-1b").reduced().with_overrides(dtype="float32", param_dtype="float32")
    lcfg = cfg.with_lora(2)
    out = {"train_loss": olmo["loss"], "train_worst_rel_l2": olmo["worst_rel_l2"],
           "ssm_train": mamba, "moe_train": moe, "encdec_train": whisper, "hybrid_train": jamba}
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


# ---------------------------------------------------------------------------
# Training mamba2-130m and federating it: ssd_intra_chunk_bwd
# ---------------------------------------------------------------------------

def _ssd_cotangents(B, L, H, P, N, Q, gen):
    """Cotangents of the intra-chunk part's three outputs, N(0, 1) fp32."""
    import torch

    n = L // Q
    return [torch.randn(s, generator=gen, device="cuda")
            for s in ((B, n, H, Q, P), (B, n, H, P, N), (B, n, H, Q))]


def phase_ssd_bwd_check():
    """The SSD backward kernel against ``ssd_intra_chunk_bwd_plain``
    computed in fp32 from the same inputs (the forward kernel's a_cs, the
    same N(0, 1) cotangents): mamba2-130m's (4, 2048, 24, 64, N 128, chunk
    256) in bf16 (the main path's call) and fp32, P and N below their
    maxima, chunks of 96, 100, 150 and 160 positions (not multiples of the
    kernel's 64-position tiles), H of 5 and 7 (not multiples of its group
    of 3 heads: clusters of 2 and 3 groups, the last one short), and N of
    36 (not a multiple of 16); jamba-1.5-large-398b's train step (1, 2048,
    256 heads) in bf16, where 86 groups of 3 heads, the last holding one,
    fill 11 clusters of 8 and leave 2 blocks of the last cluster with no
    head, and in fp32; and H of 13 and 28 (a 1-head group and empty
    cluster blocks at a small size).  fp32: within 2e-5 of each
    gradient's max(1, max|plain|); bf16 (dx, dB and dC come back in bf16):
    relative L2 <= 1e-2 per gradient.  At mamba2-130m's and jamba's shapes
    a second launch must be bit-equal.  Then the whole scan's gradient through the
    Function with an initial state (a continuation), on the card against
    autograd through the plain ``ssd_chunked`` on the card (2e-5 of
    scale).  Last, inputs the kernels do not take (P 68, N 132, fp16, B of
    another dtype than x, an odd chunk) must be refused before any launch.
    Returns the largest |kernel - plain| over the five gradients at
    mamba2-130m's and jamba's shapes in bf16."""
    import torch
    from repro_torch.kernels.ssd_scan import (
        _launch, ssd_chunk_scan, ssd_chunk_scan_plain, ssd_intra_chunk_bwd,
        ssd_intra_chunk_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(13)
    bf, f32 = torch.bfloat16, torch.float32
    full = (SSM_B, PREFILL_S, 24, 64, 128, 256)
    jamba = (1, PREFILL_S, *JAMBA_SSD)
    mains = [(full, bf), (jamba, bf), (jamba, f32)]
    cases = [(full, bf), (full, f32), (jamba, bf), (jamba, f32),
             ((1, 128, 13, 32, 64, 64), bf), ((1, 128, 28, 16, 16, 64), bf),
             ((2, 256, 8, 32, 64, 64), f32), ((2, 256, 8, 32, 64, 64), bf),
             ((1, 192, 6, 64, 128, 96), bf), ((1, 200, 4, 32, 16, 100), f32),
             ((2, 300, 5, 16, 36, 150), bf), ((2, 300, 5, 16, 36, 150), f32),
             ((1, 320, 7, 32, 64, 160), f32), ((1, 320, 7, 32, 64, 160), bf)]
    names = ("dx", "ddt", "dA", "dB", "dC")
    main_err = 0.0
    for (B, L, H, P, N, Q), dt in cases:
        args = _ssd_inputs(B, L, H, P, N, dt, gen)
        a_cs = _launch(*args, Q)[2]
        cots = _ssd_cotangents(B, L, H, P, N, Q, gen)
        got = ssd_intra_chunk_bwd(*args, a_cs, *cots)
        torch.cuda.synchronize()
        want = ssd_intra_chunk_bwd_plain(*(t.float() for t in args), a_cs, *cots)
        tol = 1e-2 if dt == bf else 2e-5
        ok, scores, errs = True, [], []
        for g, w, t in zip(got, want, args):
            ok = ok and g.dtype == t.dtype and g.shape == t.shape and bool(torch.isfinite(g).all())
            err = (g.float() - w).abs().max().item()
            errs.append(err)
            scores.append(rel_l2(g, w) if dt == bf else err / max(1.0, w.abs().max().item()))
            ok = ok and scores[-1] <= tol
        measure = "relative L2" if dt == bf else "max|kernel-plain|/max(1,max|plain|)"
        say(f"[check] ssd_intra_chunk_bwd B={B} L={L} H={H} P={P} N={N} chunk={Q} "
            f"{str(dt)[6:]}: {measure} "
            + ", ".join(f"{n} {x:.3e}" for n, x in zip(names, scores))
            + f" (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"ssd_intra_chunk_bwd {(B, L, H, P, N, Q, dt)}")
        if ((B, L, H, P, N, Q), dt) in mains:
            if dt == bf:
                main_err = max(main_err, *errs)
            again = ssd_intra_chunk_bwd(*args, a_cs, *cots)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            say(f"[check] ssd_intra_chunk_bwd at {(B, L, H, P, N, Q)} {str(dt)[6:]}, a second "
                f"launch on the same inputs: bit-equal {same} (one writer per output, no "
                f"atomics)")
            check(same, "ssd_intra_chunk_bwd is deterministic")
            del again
        del args, a_cs, cots, got, want
        torch.cuda.empty_cache()

    # The whole scan's gradient, continuing from an initial state.
    B, L, H, P, N, Q = 2, 512, 5, 32, 64, 128
    base = _ssd_inputs(B, L, H, P, N, f32, gen)
    h0 = torch.randn((B, H, P, N), generator=gen, device="cuda")
    gy = torch.randn((B, L, H, P), generator=gen, device="cuda")
    gh = torch.randn((B, H, P, N), generator=gen, device="cuda")
    grads, launches = {}, {}
    for name, fn in (("kernel", lambda *t: ssd_chunk_scan(*t, chunk=Q, initial_state=h0)),
                     ("plain", lambda *t: ssd_chunk_scan_plain(*t, Q, h0))):
        ts = [t.detach().clone().requires_grad_(True) for t in base]
        zero_counts()
        y, h = fn(*ts)
        grads[name] = torch.autograd.grad((y, h), ts, (gy, gh))
        launches[name] = counts()
    ok = (launches["kernel"]["ssd_chunk_scan"] == 1
          and launches["kernel"]["ssd_intra_chunk_bwd"] == 1
          and launches["plain"]["ssd_intra_chunk_bwd"] == 0)
    scores = []
    for g, w in zip(grads["kernel"], grads["plain"]):
        scores.append((g - w).abs().max().item() / max(1.0, w.abs().max().item()))
        ok = ok and scores[-1] <= 2e-5
    say(f"[check] ssd_chunk_scan's gradient through both kernels, continuing from an initial "
        f"state (B={B} L={L} H={H} P={P} N={N} chunk={Q} fp32), against autograd through the "
        f"plain ssd_chunked on the card: max|diff|/max(1,max|plain|) "
        + ", ".join(f"{n} {x:.3e}" for n, x in zip(names, scores))
        + f" (tol 2e-05); launches {launches['kernel']} {'ok' if ok else 'FAIL'}")
    check(ok, "the scan's gradient with an initial state")
    del base, h0, gy, gh, grads

    # Inputs the kernels do not take, refused before any launch.
    refused = []
    for what, shape, dtypes, Q in (("P 68", (1, 64, 2, 68, 16), (f32, f32), 16),
                                   ("N 132", (1, 64, 2, 16, 132), (f32, f32), 16),
                                   ("fp16", (1, 64, 2, 16, 16), (torch.float16,) * 2, 16),
                                   ("B of another dtype", (1, 64, 2, 16, 16), (f32, bf), 16),
                                   ("an odd chunk", (1, 63, 2, 16, 16), (f32, f32), 21)):
        B, L, H, P, N = shape
        x, dt_, A, Bm, Cm = _ssd_inputs(B, L, H, P, N, dtypes[0], gen)
        Bm = Bm.to(dtypes[1])
        n = L // Q
        zero_counts()
        try:
            ssd_intra_chunk_bwd(x, dt_, A, Bm, Cm, torch.zeros((B, n, H, Q), device="cuda"),
                                torch.zeros((B, n, H, Q, P), device="cuda"),
                                torch.zeros((B, n, H, P, N), device="cuda"),
                                torch.zeros((B, n, H, Q), device="cuda"))
            refused.append((what, False))
        except (TypeError, ValueError):
            refused.append((what, counts() == dict.fromkeys(KERNELS, 0)))
    ok = all(r for _, r in refused)
    say(f"[check] ssd_intra_chunk_bwd refuses, before any launch: "
        + ", ".join(f"{w} {r}" for w, r in refused) + f" {'ok' if ok else 'FAIL'}")
    check(ok, "inputs the SSD backward does not take are refused with no launch")
    torch.cuda.empty_cache()
    return main_err


def phase_ssd_bwd_timing():
    """The SSD backward alone at mamba2-130m's train step (x (4, 2048, 24,
    64), B and C (4, 2048, 128) bf16, chunk 256, fp32 cotangents): the
    kernel, its plain version and the forward kernel in the same
    ``alternating()`` rounds, and the kernel and the forward again behind a
    sleep kernel, which times their device spans; beside the backward's
    bounds.  A timed call less its device span is its host share.
    ``main`` runs this phase before any phase that traces, since a
    ``torch.profiler`` session slows the later torch calls of its process.
    Then the time a call takes to return, each of the backward's kernels'
    device time from ``torch.profiler`` (grouped by kernel name) and the
    scratch it takes.

    The needed work, counted where the decay is not zero (s <= l) as the
    forward's bound is, with the passes of 3xTF32 products on the tensor
    cores that the function needs: per (b, chunk, head) dM = dt∘(dy xᵀ)
    Q·(Q+1)·P in 2 passes (x is bf16, exact in TF32, and dt depends on s
    alone) and Mᵀ dy Q·(Q+1)·P in 3, R = B dstᵀ and the states' term of dB,
    (dt decay)∘(x dst), 2·Q·N·P each in 2; per (b, chunk) dC and dGᵀ C,
    Q·(Q+1)·N each in 2; at 495 TFLOP/s of TF32 (G = C Bᵀ on bf16 tensor
    cores, 0.27 GFLOP, is left out).  The same products as fp32 FMAs (one
    pass each, and G) at 67 TFLOP/s are printed beside it.  The bytes are
    x, B, C (bf16), dt, a_cs and the three cotangents read once, and dx,
    dB, dC (bf16), ddt and dA written once.  No single PyTorch call
    computes it.  Last, the backward, its plain version and the forward
    kernel at jamba-1.5-large-398b's train step (1, 2048, 256 heads), with
    the same bounds."""
    import torch
    from repro_torch.kernels.ssd_scan import (
        _bwd_kernel_fn, _launch, ssd_intra_chunk_bwd, ssd_intra_chunk_bwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(14)
    B, L, H, P, N, Q = SSM_B, PREFILL_S, 24, 64, 128, 256
    args = _ssd_inputs(B, L, H, P, N, torch.bfloat16, gen)
    a_cs = _launch(*args, Q)[2]
    cots = _ssd_cotangents(B, L, H, P, N, Q, gen)

    def kernel():
        ssd_intra_chunk_bwd(*args, a_cs, *cots)

    def forward():
        _launch(*args, Q)

    q4, n = alternating({"kernel": kernel,
                         "plain": lambda: ssd_intra_chunk_bwd_plain(*args, a_cs, *cots),
                         "forward": forward, "kernel_span": kernel, "forward_span": forward},
                        queued=("kernel_span", "forward_span"))
    flops, fp32_flops, nbytes = _ssd_bwd_work(B, L, H, P, N, Q)
    row = _bound_row(q4, n, flops, TF32_FLOPS_PER_S, nbytes,
                     "ssd_intra_chunk_bwd mamba2-130m train step (4, 2048, 24, 64), N 128, "
                     "chunk 256, bf16, 3xTF32 tensor-core passes", None)
    row["fp32_bound_ms"] = fp32_flops / FP32_FLOPS_PER_S * 1e3
    say(f"[time] ssd_intra_chunk_bwd: the same products as fp32 FMAs, {fp32_flops / 1e9:.2f} GFLOP "
        f"at 67 TFLOP/s = {row['fp32_bound_ms']:.4f} ms; the kernel at "
        f"{row['fp32_bound_ms'] / row['ms']:.1%} of that bound")
    fwd, span, fspan = q4["forward"], q4["kernel_span"], q4["forward_span"]
    row["forward_ms"], row["forward_quartiles_ms"] = fwd[1], fwd
    row["device_span_ms"], row["forward_span_ms"] = span[1], fspan[1]
    row["host_ms"] = row["ms"] - span[1]
    say(f"[time] ssd_chunk_scan forward kernel alone in the same rounds: median {fwd[1]:.4f} ms "
        f"(quartiles {fwd[0]:.4f}-{fwd[2]:.4f}); the backward is {row['ms'] / fwd[1]:.2f}x it")
    say(f"[time] device spans in the same rounds (behind a sleep kernel): backward median "
        f"{span[1]:.4f} ms (quartiles {span[0]:.4f}-{span[2]:.4f}), forward {fspan[1]:.4f} ms "
        f"({fspan[0]:.4f}-{fspan[2]:.4f}): {span[1] / fspan[1]:.2f}x; the backward's host share "
        f"{row['host_ms']:.4f} ms of its timed call (the earlier fp32-FMA kernel's wrapper: "
        f"~0.18 ms), the forward's {fwd[1] - fspan[1]:.4f} ms")
    torch.cuda.synchronize()
    enqueue = []
    for _ in range(20):
        t0 = time.perf_counter()
        kernel()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    row["enqueue_ms"] = statistics.median(enqueue)
    say(f"[time] ssd_intra_chunk_bwd: a call returns {row['enqueue_ms']:.4f} ms after it starts "
        f"(median of 20 back to back, no synchronize): the wrapper's host work and the launches")
    dev = _device_ms(kernel)
    split: dict = {}
    for name, t in dev.items():
        m = re.search(r"::(\w+)[<(]", name)
        key = m.group(1) if m else name[:40]
        split[key] = split.get(key, 0.0) + t
    row["device_ms_by_kernel"], row["device_ms"] = split, sum(dev.values())
    row["scratch_bytes"] = 4 * _bwd_kernel_fn()[1](B, L, H, P, N, Q, 1)
    if not dev:
        say("[time] ssd_intra_chunk_bwd: the profiler recorded no device time")
    else:
        say(f"[time] ssd_intra_chunk_bwd device time a call by kernel (torch.profiler, 5 calls): "
            + ", ".join(f"{k} {t:.4f} ms" for k, t in split.items())
            + f"; {row['device_ms']:.4f} ms in all")
    say(f"[time] ssd_intra_chunk_bwd scratch a call: {row['scratch_bytes'] / 1e6:.1f} MB "
        f"(the earlier fp32-FMA kernel's layout: 159 MB)")
    del args, a_cs, cots

    # jamba-1.5-large-398b's train step: 256 heads, the backward beside the
    # forward kernel and its plain version in the same rounds.
    B, L, H, P, N, Q = 1, PREFILL_S, *JAMBA_SSD
    args = _ssd_inputs(B, L, H, P, N, torch.bfloat16, gen)
    a_cs = _launch(*args, Q)[2]
    cots = _ssd_cotangents(B, L, H, P, N, Q, gen)
    q4, n = alternating({"kernel": lambda: ssd_intra_chunk_bwd(*args, a_cs, *cots),
                         "plain": lambda: ssd_intra_chunk_bwd_plain(*args, a_cs, *cots),
                         "forward": lambda: _launch(*args, Q)})
    flops, fp32_flops, nbytes = _ssd_bwd_work(B, L, H, P, N, Q)
    jamba = _bound_row(q4, n, flops, TF32_FLOPS_PER_S, nbytes,
                       f"ssd_intra_chunk_bwd {JAMBA} train step ({B}, {L}, {H}, {P}), N {N}, "
                       f"chunk {Q}, bf16, 3xTF32 tensor-core passes", None)
    jamba["fp32_bound_ms"] = fp32_flops / FP32_FLOPS_PER_S * 1e3
    jamba["forward_ms"] = q4["forward"][1]
    say(f"[time] ssd_intra_chunk_bwd at {JAMBA}'s shape: {jamba['ms'] / q4['forward'][1]:.2f}x "
        f"the forward kernel ({q4['forward'][1]:.4f} ms) in the same rounds; fp32-FMA bound "
        f"{jamba['fp32_bound_ms']:.4f} ms")
    row["jamba"] = jamba
    del args, a_cs, cots
    torch.cuda.empty_cache()
    return row


def _ssd_bwd_work(B: int, L: int, H: int, P: int, N: int, Q: int) -> tuple:
    """The SSD backward's needed work (``phase_ssd_bwd_timing``): its 3xTF32
    tensor-core passes and the same products as fp32 FMAs, in flops, and
    the bytes read and written once."""
    C = L // Q
    mm, pairs = Q * (Q + 1), 2 * Q * N * P
    flops = B * C * H * (5 * mm * P + 4 * pairs) + B * C * 4 * mm * N
    fp32_flops = B * C * H * (2 * mm * P + 2 * pairs) + B * C * 3 * mm * N
    nbytes = (2 * B * L * H * P * 2 + 4 * B * L * N * 2 + 2 * B * L * H * 4 + H * 4
              + B * C * H * (2 * Q + Q * P + P * N) * 4)
    return flops, fp32_flops, nbytes


def _zoo_train_phase(arch: str, batch: int, trainer_args: "list | None",
                     seq: int = PREFILL_S, overrides: "dict | None" = None) -> dict:
    """``arch`` at full width and depth in bf16 (``overrides`` applied to its
    config, e.g. a memory cut), random weights from seed 0, through
    ``make_train_step`` with ``make_optimizer_for`` (AdamW, the config's
    state dtype) on (batch, seq) batches of ``SyntheticLM`` tokens (an
    encoder-decoder's with (batch, 1500, d) frames drawn after them): one
    warm-up step, TRAIN_STEPS timed ones (host clock ending in a
    synchronize), each with the forward and backward launches of
    ``_launches`` and nothing else, losses finite; one more step under
    ``torch.profiler``.  First the gradients of two differentiations of the
    loss from the same weights and batch must be bit-equal (no atomic
    accumulation on the path).  Then the trainer as a user runs it, in its
    own process: ``python -m repro_torch.launch.train --arch <arch>`` with
    ``trainer_args`` must exit 0 (the loss fell).  With ``trainer_args``
    None no trainer runs (its CLI has no flag for a cut), and the phase's
    own loss must fall instead: the warm-up batch's loss after the phase's
    steps below the warm-up step's.  (Each ``SyntheticLM`` batch of 2048
    tokens walks its own few thousand states of a 4-way Markov chain, so
    six steps barely move the loss of a batch no step took.)"""
    import os

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_optimizer_for, make_train_step
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    cfg = get_config(arch).with_overrides(**(overrides or {}))
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = make_optimizer_for(cfg)
    step = make_train_step(model, opt)
    ds = SyntheticLM(cfg.vocab_size, seq, seed=0)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(TRAIN_STEPS + 2):
        batches.append(_lm_batch(ds, rng, batch))
        if cfg.arch_type == "encdec":
            batches[-1]["frames"] = _frames(rng, batch, cfg)
    tag = f"[train] {arch} bf16" + (f" ({overrides})" if overrides else "")
    only = dict.fromkeys(KERNELS, 0) | _launches(cfg) | _launches(cfg, True)
    leaves, treedef = tree_flatten(params)
    grads = []
    for _ in range(2):
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss = model.loss(tree_unflatten(treedef, live), batches[0])
        grads.append((loss.detach(), torch.autograd.grad(loss, live)))
    (l1, g1), (l2, g2) = grads
    same = [torch.equal(a, b) for a, b in zip(g1, g2)]
    say(f"{tag}: two gradients from the same weights and batch ({batch}, {seq}): "
        f"losses {float(l1):.6f} / {float(l2):.6f} bit-equal {torch.equal(l1, l2)}; "
        f"{sum(same)} of {len(same)} leaves' gradients bit-equal")
    check(torch.equal(l1, l2) and all(same), f"{arch}: repeated gradients bit-equal")
    out = {"repeat_grads_bit_equal": all(same), "params": model.param_count(params)}
    del grads, g1, g2, live, loss, leaves
    state = opt.init(params)
    zero_counts()
    params, state, loss = step(params, state, batches[0])   # warm-up
    torch.cuda.synchronize()
    first = float(loss)
    check(counts() == only and math.isfinite(first), f"warm-up step launches {counts()}")
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
    say(f"{tag}: {model.param_count(params):,} params, batch ({batch}, {seq}): train step "
        f"median {med * 1e3:.1f} ms, quartiles {q1 * 1e3:.1f}-{q3 * 1e3:.1f} ms over "
        f"{TRAIN_STEPS} steps (each {', '.join(f'{t * 1e3:.1f}' for t in times)}); losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; launches a step {all_launches[-1]}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(all(math.isfinite(x) for x in losses), f"{arch} train step losses finite")
    check(all(n == only for n in all_launches),
          f"a {arch} train step launches {_nonzero(only)}, got {all_launches}")
    zero_counts()
    holder = {}
    # The profiler's own device buffers come on top of the step's peak
    # (jamba's cut runs at 75.9 of 79.2 GiB): hand the allocator's free
    # cached blocks back first, or the traced step can run out of memory.
    torch.cuda.empty_cache()

    def traced():
        holder["out"] = step(params, state, batches[-1])

    trace = _trace_prefill(traced, tag, "train step")
    check(counts() == only, f"traced {arch} train step launches")
    del holder
    out.update(step_s=med, step_s_quartiles=(q1, med, q3), step_s_runs=times,
               losses=[first] + losses, launches=all_launches[-1], peak_bytes=peak, trace=trace)
    if trainer_args is None:
        with torch.no_grad():
            again, unseen = (float(model.loss(params, b)) for b in (batches[0], batches[-1]))
        say(f"{tag}: the warm-up batch's loss {first:.4f} before the phase's {TRAIN_STEPS + 1} "
            f"steps, {again:.4f} after (a batch no step took: {unseen:.4f}); no trainer "
            f"process (its CLI takes no cut)")
        check(math.isfinite(again) and again < first, f"{arch}: the loss falls over the phase")
        out.update(loss_after=again, unseen_batch_loss=unseen)
    del params, state, batches
    torch.cuda.empty_cache()
    if trainer_args is None:
        return out

    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch] + trainer_args
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.monotonic() - t0
    for line in (proc.stdout + proc.stderr).splitlines():
        say(f"[trainer] {line}")
    m = re.search(r"done: loss ([0-9.naif]+) -> ([0-9.naif]+)", proc.stdout)
    t_first, last = (float(m.group(1)), float(m.group(2))) if m else (None, None)
    say(f"[trainer] python -m repro_torch.launch.train --arch {arch} {' '.join(trainer_args)}: "
        f"exit code {proc.returncode} in {wall:.1f} s; first loss {t_first}, last {last}")
    check(proc.returncode == 0 and "device=cuda" in proc.stdout,
          f"the {arch} trainer exits 0 on the card (the loss fell)")
    out["trainer"] = {"rc": proc.returncode, "first_loss": t_first, "last_loss": last,
                      "wall_s": wall}
    return out


def phase_ssm_train_step():
    """mamba2-130m on (4, 2048) batches, 24 ``ssd_chunk_scan`` forward and
    24 backward launches a step (``_zoo_train_phase``); its trainer with
    ``--steps 8 --batch 4 --seq 2048``."""
    return _zoo_train_phase("mamba2-130m", SSM_B,
                            ["--steps", "8", "--batch", str(SSM_B), "--seq", str(PREFILL_S)])


def phase_moe_train_step():
    """granite-moe-1b-a400m on (2, 2048) batches, 24 ``flash_attention``
    forward and 24 backward launches a step (``_zoo_train_phase``); the
    reference's trainer command ``--arch granite-moe-1b-a400m`` with its
    defaults (50 steps of (8, 128))."""
    return _zoo_train_phase("granite-moe-1b-a400m", TRAIN_B, [])


def phase_encdec_train_step():
    """whisper-small on (8, 448) token batches over (8, 1500, 768) frames:
    36 ``flash_attention`` forward and 36 backward launches a step (12
    encoder, 12 decoder self, 12 cross; ``_zoo_train_phase``); the
    reference's trainer command ``--arch whisper-small`` with its defaults
    (50 steps of (8, 128) tokens, each over (8, 1500) frames)."""
    return _zoo_train_phase("whisper-small", WHISPER_B, [], seq=WHISPER_S)


def phase_hybrid_train_step():
    """jamba-1.5-large-398b at the training cut (``JAMBA_TRAIN_CUT``) on (1,
    2048) batches with the config's bf16 AdamW moments: 1 flash and 7 SSD
    scan forward launches and as many backward launches a step
    (``_zoo_train_phase``).  No trainer process: the trainer's CLI, like the
    reference's, takes no override, and the whole config does not fit one
    card; the phase's own loss must fall instead."""
    return _zoo_train_phase(JAMBA, 1, None, overrides=JAMBA_TRAIN_CUT)


def _zoo_fedavg_phase(arch: str, fwd: str, bwd: str) -> dict:
    """FedAvg of ``arch`` at full width, the system's main path:
    ``FLServer`` barrier rounds over ZOO_SILOS silos of ``make_lm_silos``
    (4 train and 2 test sequences of 2048 tokens each), ``FLClient`` with
    the zoo's loss and ``make_optimizer_for`` (AdamW), batch 2, so 2 local
    steps a round; 2 rounds, no checkpoints (the FEMNIST path writes them).
    After each round the global weights must be the ``n_samples``-weighted
    mean of the silos' weights as ``fedavg_reduce_plain`` computes it on the
    card from the same (N, L) fp32 buffer, within the barrier-round
    kernel check's tolerance for the leaf's dtype (2e-5 fp32, 2e-2 bf16,
    absolute and relative); each round must launch ``fedavg_reduce`` once,
    and ``fwd`` and ``bwd`` once a layer a batch (forward for the 2 train
    and 1 eval batch of each silo, backward for the train batches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_silos
    from repro_torch.federated import FLClient, FLServer
    from repro_torch.federated.agg_engine import plan_for
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce_plain
    from repro_torch.launch.steps import make_optimizer_for
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_flatten

    cfg = get_config(arch)
    model = get_model(cfg)
    params0 = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = model.param_count(params0)
    silos = make_lm_silos(ZOO_SILOS, cfg.vocab_size, PREFILL_S, [(4, 2)] * ZOO_SILOS, seed=0)

    def loss_fn(p, b):
        return model.loss(p, {"tokens": b[0], "labels": b[1]})

    results = {}

    class Client(FLClient):
        def train(self, global_params):
            res = super().train(global_params)
            results[self.client_id] = res
            return res

    clients = [Client(s.client_id, s, loss_fn, make_optimizer_for(cfg), batch_size=2,
                      device="cuda") for s in silos]
    folds = []

    def check_fold(round_idx, params):
        res = [results[c.client_id] for c in clients]
        plan = plan_for(params)
        stacked = plan.flatten_stack([r.params for r in res])
        w = torch.tensor([float(r.n_samples) for r in res], device="cuda")
        want = tree_flatten(plan.unflatten(fedavg_reduce_plain(stacked, w)))[0]
        worst = {}
        for got, exp in zip(tree_flatten(params)[0], want):
            tol = 2e-2 if got.dtype == torch.bfloat16 else 2e-5
            key = str(got.dtype)[6:]
            err = (got.float() - exp.float()).abs().max().item()
            worst[key] = max(worst.get(key, 0.0), err)
            check(torch.allclose(got.float(), exp.float(), atol=tol, rtol=tol),
                  f"round {round_idx}: the fold is the n_samples-weighted mean ({key})")
        folds.append({"round": round_idx, "n_samples": [r.n_samples for r in res],
                      "max_abs_err": worst})
        del stacked, want
        return None

    per_round = {"fedavg_reduce": 1, fwd: ZOO_SILOS * (2 + 1) * cfg.n_layers,
                 bwd: ZOO_SILOS * 2 * cfg.n_layers}
    launches_after = []

    def hook(round_idx, params):
        out = check_fold(round_idx, params)
        launches_after.append(counts())
        return out

    server = FLServer(clients, params0, measure_round_messages=False, post_round_hook=hook,
                      device="cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    run = server.run(2)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    tag = f"[fedavg] {arch} bf16"
    rounds = []
    # agg_time_s runs from the fold's start to the end of the post-round
    # hook, here the check against the plain mean; round_span_s is the
    # engine's fold alone, to the device's finish.
    for rec, fold in zip(run.rounds, folds):
        say(f"{tag} round {rec.round_idx}: loss {rec.metrics['loss']:.4f}; train "
            f"{rec.train_time_s:.3f} s, fold {rec.round_span_s:.4f} s (then the hook's check "
            f"{rec.agg_time_s - rec.round_span_s:.4f} s), eval {rec.eval_time_s:.3f} s; "
            f"fold against the plain weighted mean (weights {fold['n_samples']}): max|diff| "
            + ", ".join(f"{k} {v:.3e}" for k, v in fold["max_abs_err"].items()))
        rounds.append({"round": rec.round_idx, "loss": rec.metrics["loss"],
                       "train_s": rec.train_time_s, "fold_s": rec.round_span_s,
                       "check_s": rec.agg_time_s - rec.round_span_s,
                       "eval_s": rec.eval_time_s, "fold_max_abs_err": fold["max_abs_err"]})
    want = dict.fromkeys(KERNELS, 0) | {k: 2 * v for k, v in per_round.items()}
    say(f"{tag}: {ZOO_SILOS} silos, {n_params:,} parameters, 2 rounds in {wall:.1f} s; launches "
        f"{launches}; by round 1's fold {launches_after[0]}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    check(len(folds) == 2 and all(math.isfinite(r["loss"]) for r in rounds),
          f"two FedAvg rounds of {arch} with finite losses")
    # The hook runs after the fold and before the round's evaluation.
    first_fold = dict.fromkeys(KERNELS, 0) | per_round | {fwd: per_round[bwd]}
    check(launches_after[0] == first_fold and launches == want,
          f"a FedAvg round launches {per_round}, got {launches_after[0]} by round 1's fold, "
          f"then {launches}")
    trees = [results[c.client_id].params for c in clients]
    weights = [float(results[c.client_id].n_samples) for c in clients]
    del server, run, clients, params0, results
    torch.cuda.empty_cache()
    parts = _fold_parts(trees, weights, n=3)
    say(f"{tag}: the fold at L = {n_params:,}, {ZOO_SILOS} silos (round 2's weights): " + ", ".join(
        f"{k} {v:.4f}" for k, v in parts.items()))
    del trees
    torch.cuda.empty_cache()
    return {"rounds": rounds, "launches": launches, "wall_s": wall, "peak_bytes": peak,
            "n_params": n_params, "fold_parts": parts}


def phase_ssm_fedavg_rounds():
    """FedAvg of mamba2-130m silos (``_zoo_fedavg_phase``): both SSD kernels."""
    return _zoo_fedavg_phase("mamba2-130m", "ssd_chunk_scan", "ssd_intra_chunk_bwd")


def phase_moe_fedavg_rounds():
    """FedAvg of granite-moe-1b-a400m silos (``_zoo_fedavg_phase``): both
    flash kernels and ``fedavg_reduce`` over L = 1,334,628,352."""
    return _zoo_fedavg_phase("granite-moe-1b-a400m", "flash_attention", "flash_attention_bwd")


# ---------------------------------------------------------------------------
# The two-level hierarchy and the stacked reduce
# ---------------------------------------------------------------------------

HIER_SILOS = 6          # phase_hierarchy_exactness's dyadic silos
HIER_ROUNDS = 4         # phase_hierarchy_round's rounds
HIER_DEADLINE_S = 3.0   # its FixedDeadline; femnist_client_3 arrives at 6.0 s in round 3
# The §5.6 Poisson revocation process of phase_hierarchy_round, its only
# spot silo femnist_client_1: from this seed the first event lands 1.91 s
# into the run (0.11 s into round 2, whose silos arrive at 1.0-1.8 s) and
# the second at 19.7 s, after round 4 (the rounds' horizons are 1.8, 1.8,
# 6.0 and 1.8 s).
HIER_REVOCATION = {"k_r": 5.0, "seed": 139}
HIER_LORA_ROUNDS = 2


class _pod_of_one:
    """An NCCL process group of one process (``init_method="file://..."``)
    and its 1-D "pod" DeviceMesh, destroyed on exit: the sharded parent's
    collective on one card.  The group must be gone before the live phases
    spawn processes."""

    def __enter__(self):
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        self._dir = tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_pg_")
        dist.init_process_group("nccl", init_method=f"file://{self._dir.name}/pg",
                                world_size=1, rank=0, device_id=torch.device("cuda", 0))
        check(dist.get_backend() == "nccl", f"the pod's backend is nccl, got {dist.get_backend()}")
        return DeviceMesh("cuda", [0], mesh_dim_names=("pod",))

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        self._dir.cleanup()
        return False


def _bit_equal(got, want) -> bool:
    """Every leaf equal, the sign of a zero too."""
    import torch
    from repro_torch.utils.tree import tree_leaves

    return all(torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _max_abs(got, want) -> float:
    from repro_torch.utils.tree import tree_leaves

    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def phase_hierarchy_exactness():
    """The partition property at the paper's FEMNIST width: HIER_SILOS
    silos of dyadic trees (integers in [-128, 128) x 2^-6, integer weights
    1-15; no sum of them rounds) in the CNN's layout (L = 164,187,070),
    made on the card from seed 0, folded through four partitions (one
    region, singletons, round-robin 3, [2, 0, 1, 0, 2, 1]), dense and as
    fp16 updates (``dequant_fold``, scale 1), with the sequential parent
    and the sharded one (an all-reduce over an NCCL pod of one process):
    each bit-equal to the flat ``streaming(base=...)`` fold of the same
    updates.  The structured full-coverage route (``{"all": ""}``) must be
    bit-equal to the dense hierarchy, int8 within 1e-6 of the flat int8
    fold.  Then one ``fold_partial`` add and the parent's whole
    ``fold_partials`` over three regions are timed beside their bounds."""
    import torch
    import torch.distributed as dist
    from repro_torch.federated import (
        AggregationEngine,
        ClientResult,
        HierarchyCoordinator,
        InstantSchedule,
        partition_regions,
        plan_for,
    )
    from repro_torch.federated.agg_engine import _flat_partial_fold
    from repro_torch.federated.compression import CompressionSpec, compress
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.utils.tree import tree_map

    gen = torch.Generator(device="cuda").manual_seed(0)
    template = init_femnist_cnn(gen, FemnistConfig(), "cuda")

    def dyadic():
        return tree_map(lambda t: torch.randint(-128, 128, t.shape, generator=gen, device="cuda",
                                                dtype=torch.int32).float() * 2.0**-6, template)

    base = dyadic()
    weights = torch.randint(1, 16, (HIER_SILOS,), generator=gen, device="cuda").tolist()
    dense = [ClientResult(f"silo{i}", dyadic(), w, 0.0) for i, w in enumerate(weights)]
    del template
    plan = plan_for(base)
    check(plan.total_elems == PAPER_L, f"the CNN's layout holds {PAPER_L} parameters")
    base_flat = plan.flatten(base)

    def compressed(codec):
        return [ClientResult(r.client_id, compress(plan.flatten(r.params) - base_flat,
                                                   CompressionSpec(codec), base_round=0),
                             r.n_samples, 0.0) for r in dense]

    results = {"dense": dense, "fp16": compressed("fp16"), "int8": compressed("int8")}
    del base_flat

    def flat(res):
        agg = AggregationEngine().streaming(base=base, base_round=0)
        for r in res:
            agg.add(r.params, r.n_samples)
        return agg.result()

    want = {codec: flat(res) for codec, res in results.items()}
    torch.cuda.synchronize()
    ids = [r.client_id for r in dense]
    partitions = {"one region": {"r0": ids},
                  "singletons": {f"r{i}": [cid] for i, cid in enumerate(ids)},
                  "round-robin 3": partition_regions(ids, 3),
                  "[2, 0, 1, 0, 2, 1]": {}}
    for cid, j in zip(ids, [2, 0, 1, 0, 2, 1]):
        partitions["[2, 0, 1, 0, 2, 1]"].setdefault(f"r{j}", []).append(cid)
    out = {"routes": [], "weights": weights}
    wsum = float(sum(weights))

    with _pod_of_one() as mesh:
        zero_counts()
        folders = []

        def route(name, codec, sharded, rmap, schema=None):
            coord = HierarchyCoordinator(rmap, agg_engine=AggregationEngine(), sharded=sharded,
                                         mesh=mesh if sharded else None, schema=schema)
            if sharded:
                folders.append((len(rmap), coord.folder))
            rep = coord.fold_round(0, results[codec], InstantSchedule(), base_params=base)
            n = sum(p.n_clients for p in rep.partials)
            w = sum(p.wsum for p in rep.partials)
            check(n == HIER_SILOS and w == wsum,
                  f"{name}: the partials carry every silo once ({n} silos, wsum {w} of {wsum})")
            return rep

        for pname, rmap in partitions.items():
            for codec in ("dense", "fp16"):
                for sharded in (False, True):
                    rep = route(pname, codec, sharded, rmap)
                    equal = _bit_equal(rep.params, want[codec])
                    parent = "sharded" if sharded else "sequential"
                    say(f"[hierarchy] exactness {pname}, {codec}, {parent} parent: "
                        f"{len(rep.partials)} partials, bit-equal to the flat fold: {equal}")
                    check(equal, f"{pname} {codec} {parent}: bit-equal to the flat fold")
                    out["routes"].append({"partition": pname, "codec": codec, "parent": parent,
                                          "bit_equal": equal})
                    if pname == "round-robin 3" and codec == "dense" and not sharded:
                        partials = rep.partials
                    del rep
            rep = route(pname, "dense", False, rmap, schema={"all": ""})
            equal = _bit_equal(rep.params, want["dense"])
            say(f"[hierarchy] exactness {pname}, structured full coverage, sequential parent: "
                f"bit-equal to the dense hierarchy: {equal}")
            check(equal, f"{pname}: structured full coverage bit-equal to the dense hierarchy")
            out["routes"].append({"partition": pname, "codec": "structured", "parent": "sequential",
                                  "bit_equal": equal})
            del rep
        rmap = partitions["round-robin 3"]
        rep = route("round-robin 3", "dense", True, rmap, schema={"all": ""})
        equal = _bit_equal(rep.params, want["dense"])
        check(equal, "round-robin 3: structured full coverage, sharded, bit-equal")
        out["routes"].append({"partition": "round-robin 3", "codec": "structured",
                              "parent": "sharded", "bit_equal": equal})
        del rep
        for sharded in (False, True):
            rep = route("round-robin 3", "int8", sharded, rmap)
            err = _max_abs(rep.params, want["int8"])
            parent = "sharded" if sharded else "sequential"
            say(f"[hierarchy] exactness round-robin 3, int8, {parent} parent: max|hier - flat| "
                f"{err:.3e} (tol 1e-6)")
            check(err <= 1e-6, f"int8 {parent}: within 1e-6 of the flat int8 fold")
            out["routes"].append({"partition": "round-robin 3", "codec": "int8",
                                  "parent": parent, "max_abs_err": err})
            del rep
        torch.cuda.synchronize()
        launches = counts()
        # A parent with one partial folds it in place, as the reference does.
        n_coll = [f.n_collectives for _, f in folders]
        backend = dist.get_backend()
        say(f"[hierarchy] exactness: launches {_nonzero(launches)}; all-reduces per sharded "
            f"route {n_coll} over backend {backend}")
        # fp16: 4 partitions x 2 parents; int8: 2 parents; a launch an update.
        want_launches = dict.fromkeys(KERNELS, 0) | {"dequant_fold": HIER_SILOS * (8 + 2)}
        check(launches == want_launches, f"hierarchy routes launch {want_launches}")
        check(all(f.n_collectives == int(r > 1) for r, f in folders),
              "every sharded route over two or more regions ran one all-reduce")
        out.update(launches=launches, n_collectives=n_coll, backend=backend)

        # Timing: one partial add, and the parent's fold of three partials.
        l_pad = partials[0].acc.numel()
        acc = partials[0].acc.clone()
        other = partials[1].acc
        add_ms = statistics.median(cuda_times(lambda: _flat_partial_fold(acc, other), 20))
        add_bound = 3 * 4 * l_pad / HBM_BYTES_PER_S * 1e3
        fold_bound = 4 * (len(partials) * l_pad + 2 * PAPER_L) / HBM_BYTES_PER_S * 1e3
        seq = HierarchyCoordinator(rmap, agg_engine=AggregationEngine())
        shd = HierarchyCoordinator(rmap, agg_engine=AggregationEngine(), sharded=True, mesh=mesh)
        fold_ms = {}
        for name, coord in (("sequential", seq), ("sharded", shd)):
            for _ in range(2):
                coord.fold_partials(0, partials, base)
            fold_ms[name] = quartiles(cuda_times(lambda: coord.fold_partials(0, partials, base), 8))
        say(f"[time] fold_partial add (L_pad {l_pad:,} fp32): {add_ms:.4f} ms, bound "
            f"{add_bound:.4f} ms (3 x 4 x L_pad B at 3.35 TB/s), {add_bound / add_ms:.1%}")
        for name, (q1, q2, q3) in fold_ms.items():
            say(f"[time] parent fold_partials, {len(partials)} regions, {name}: {q2:.4f} ms "
                f"({q1:.4f}-{q3:.4f}), bound {fold_bound:.4f} ms (4 x (3 L_pad + 2 L) B), "
                f"{fold_bound / q2:.1%}")
        out.update(add_ms=add_ms, add_bound_ms=add_bound, fold_partials_ms=fold_ms,
                   fold_bound_ms=fold_bound)
        del acc, other, partials, seq, shd
    del results, want, dense, base
    torch.cuda.empty_cache()
    return out


class _RoundDelays:
    """Per-round ``DeterministicSchedule`` delays (an ``ArrivalSchedule``)."""

    def __init__(self, by_round: dict):
        self.by_round = by_round

    def round_arrivals(self, round_idx, client_ids):
        from repro_torch.federated import DeterministicSchedule

        return DeterministicSchedule(self.by_round[round_idx]).round_arrivals(round_idx,
                                                                              client_ids)


class _Drawn:
    """An ``ArrivalSchedule`` whose arrivals are drawn from ``inner`` once a
    round for the whole population and served to every caller.  The
    hierarchy asks its schedule once a region, and a
    ``RevocationInjector``'s cross-round clock moves on every call: asked
    region by region, it would revoke other silos than the flat twin's."""

    def __init__(self, inner, population):
        self.inner, self.population, self.rounds = inner, list(population), {}

    def round_arrivals(self, round_idx, client_ids):
        if round_idx not in self.rounds:
            self.rounds[round_idx] = self.inner.round_arrivals(round_idx, self.population)
        return {cid: self.rounds[round_idx][cid] for cid in client_ids}


def _watch_coordinator(coord) -> tuple:
    """Wrap a coordinator for a run: CUDA events round its parent fold
    (``fold_partials``) each round, and each round's inputs and params
    kept (``fold_round``) for a flat replay.  Returns (spans, rounds)."""
    import torch

    fold_partials, fold_round, spans, rounds = coord.fold_partials, coord.fold_round, [], []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params = fold_partials(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return params

    def kept(round_idx, results, schedule=None, base_params=None):
        rep = fold_round(round_idx, results, schedule, base_params=base_params)
        rounds.append((round_idx, list(results), base_params, rep))
        return rep

    coord.fold_partials, coord.fold_round = timed, kept
    return spans, rounds


def _ratio(got, want) -> float:
    """max |got - want| / (1e-6 + 1e-6 |want|) over every element: <= 1
    is within 1e-6 absolute + relative."""
    return max(((a - b).abs() / (1e-6 + 1e-6 * b.abs())).max().item()
               for a, b in zip(got, want))


def phase_hierarchy_round():
    """``HierarchicalFLServer`` at the paper's FEMNIST width: the five silos
    of ``femnist_application()`` (batch 32, AdamW, in process), int8
    updates, regions of ``aws_gcp_environment()`` (§5.7: AWS us-east-1
    holds femnist_client_0 and 1, GCP us-central1 2 and 3, GCP us-west1
    4), the sharded parent on an NCCL pod of one process; HIER_ROUNDS
    rounds with a ``FixedDeadline`` over per-round ``DeterministicSchedule``
    delays under a ``RevocationInjector`` (round 2: femnist_client_1
    revoked and re-requested in its region; round 3: femnist_client_3
    past the deadline, parked in gcp_us_central1; round 4: folded at its
    discount).  A flat ``AsyncFLServer`` twin runs the same silos,
    schedule, deadline and codec.  Then a sequential run of 2 rounds with
    ``cohort=4, cohort_seed=9``."""
    import torch
    from repro_torch.core import aws_gcp_environment
    from repro_torch.core.events import PartialFolded, RegionClosed
    from repro_torch.core.revocation import RevocationModel
    from repro_torch.federated import (
        AggregationEngine,
        AsyncFLServer,
        AsyncRoundEngine,
        CohortSampler,
        FixedDeadline,
        HierarchicalFLServer,
        RevocationInjector,
    )
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves

    cfg = FemnistConfig()
    clients = _femnist_clients(cfg, _femnist_live_silos(), make_optimizer("adamw", 1e-4), "cuda")
    ids = [c.client_id for c in clients]
    names = list(aws_gcp_environment().regions)
    regions = dict(zip(names, (ids[0:2], ids[2:4], ids[4:5])))
    check(list(regions) == ["aws_us_east_1", "gcp_us_central1", "gcp_us_west1"],
          f"the AWS/GCP testbed's regions, got {list(regions)}")
    on_time = {cid: 1.0 + 0.2 * i for i, cid in enumerate(ids)}
    delays = {r: dict(on_time) for r in range(1, HIER_ROUNDS + 1)}
    delays[3][ids[3]] = 6.0

    def schedule():
        return _Drawn(RevocationInjector(_RoundDelays(delays), RevocationModel(**HIER_REVOCATION),
                                         spot_clients=[ids[1]]), ids)

    params0 = init_femnist_cnn(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    kw = dict(round_deadline=FixedDeadline(t_round_s=HIER_DEADLINE_S), recovery_delay_s=0.5,
              compression="int8", device="cuda")
    out = {"regions": regions}
    # cuDNN's default convolution backward sums in no fixed order, so two
    # trainings from the same weights differ (round 1 up to 7e-4 apart on
    # an H100); deterministic algorithms make the twins' silos send the
    # same updates, and leave the folds to differ.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with _pod_of_one() as mesh:
        runs = {}
        for name in ("hierarchy", "flat"):
            seen = {}

            def hook(r, params, seen=seen, name=name):
                if r == 1:
                    seen["round1"] = [t.clone() for t in tree_leaves(params)]
                if name == "hierarchy" and r == 3:
                    seen["carry"] = [(rid, e.client_id)
                                     for rid, e in seen["coordinator"].pending_carryover()]
                return None

            if name == "hierarchy":
                server = HierarchicalFLServer(clients, params0, schedule=schedule(),
                                              regions=regions, sharded=True, mesh=mesh,
                                              post_round_hook=hook, **kw)
                seen["coordinator"] = server.coordinator
                spans, kept = _watch_coordinator(server.coordinator)
            else:
                server = AsyncFLServer(clients, params0, schedule=schedule(),
                                       post_round_hook=hook, **kw)
            zero_counts()
            t0 = time.monotonic()
            run = server.run(HIER_ROUNDS)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            runs[name] = {"server": server, "run": run, "launches": counts(), "wall_s": wall,
                          **seen}
        hier, flat = runs["hierarchy"], runs["flat"]
        hs = hier["server"]
        rows = []
        for rec, rep, (start, end) in zip(hier["run"].rounds, hs.fold_reports, spans):
            wire = sum(p.wire_bytes for p in rep.partials)
            row = {"round": rec.round_idx, "loss": rec.metrics["loss"],
                   "train_s": rec.train_time_s, "fold_s": rec.agg_time_s,
                   "eval_s": rec.eval_time_s,
                   "region_fold_s": {rid: r.busy_s for rid, r in rep.region_reports.items()},
                   "parent_fold_s": rep.parent_fold_s,
                   "parent_fold_device_ms": start.elapsed_time(end),
                   "partial_wire_bytes": wire, "rerequested": rep.rerequested,
                   "carried_over": rep.carried_over, "carried_in": rep.carried_in}
            rows.append(row)
            say(f"[hierarchy] round {rec.round_idx}: loss {rec.metrics['loss']:.4f}; train "
                f"{rec.train_time_s:.3f} s, fold {rec.agg_time_s:.4f} s, eval "
                f"{rec.eval_time_s:.3f} s; regions' fold spans "
                f"{ {rid: round(s, 4) for rid, s in row['region_fold_s'].items()} } s; parent "
                f"fold {rep.parent_fold_s * 1e3:.3f} ms host, {row['parent_fold_device_ms']:.3f} "
                f"ms device; partials {wire:,} B ({len(rep.partials)} x fp32 acc); re-requested "
                f"{rep.rerequested}, carried over {rep.carried_over}, in {rep.carried_in}")
        for rec in flat["run"].rounds:
            say(f"[hierarchy] flat twin round {rec.round_idx}: loss {rec.metrics['loss']:.4f}; "
                f"train {rec.train_time_s:.3f} s, fold {rec.agg_time_s:.4f} s, eval "
                f"{rec.eval_time_s:.3f} s")
        r1 = _ratio(hier["round1"], flat["round1"])
        final_rel = rel_l2(torch.cat([t.reshape(-1) for t in tree_leaves(hier["run"].final_params)]),
                           torch.cat([t.reshape(-1) for t in tree_leaves(flat["run"].final_params)]))
        losses = [(h.metrics["loss"], f.metrics["loss"])
                  for h, f in zip(hier["run"].rounds, flat["run"].rounds)]
        say(f"[hierarchy] against the flat twin: round 1 max |dw| / (1e-6 + 1e-6 |w|) {r1:.3f} "
            f"(<= 1); final params relative L2 {final_rel:.3e}; losses {losses}; "
            f"wall {hier['wall_s']:.1f} s against {flat['wall_s']:.1f} s; launches "
            f"{_nonzero(hier['launches'])} against {_nonzero(flat['launches'])}")
        check(r1 <= 1.0, "round 1's params within 1e-6 abs + rel of the flat twin")
        # Every round's fold replayed through a flat AsyncRoundEngine on the
        # same encoded updates, base and arrivals (its own carry buffer):
        # the hierarchy's property, apart from the training's amplification
        # of rounding that moves the twin from round 2 on.
        shadow = AsyncRoundEngine(AggregationEngine(), deadline=kw["round_deadline"],
                                  recovery_delay_s=kw["recovery_delay_s"])
        replay_schedule = schedule()
        fold_ratios = []
        for round_idx, res, base, rep in kept:
            srep = shadow.fold_round(round_idx, res, replay_schedule, base_params=base)
            fold_ratios.append(_ratio(tree_leaves(rep.params), tree_leaves(srep.params)))
            check((srep.rerequested, srep.carried_over, srep.carried_in)
                  == (rep.rerequested, rep.carried_over, rep.carried_in),
                  f"round {round_idx}: the flat replay re-requests and carries the same silos")
            del srep
        del kept
        say(f"[hierarchy] each round's fold against the flat fold of the same updates: max "
            f"|dw| / (1e-6 + 1e-6 |w|) {[round(x, 4) for x in fold_ratios]} (<= 1)")
        check(max(fold_ratios) <= 1.0, "every round within 1e-6 abs + rel of the flat fold")
        check(hier["launches"]["dequant_fold"] == flat["launches"]["dequant_fold"] > 0,
              "dequant_fold launches equal to the twin's")
        check(hier["launches"] == flat["launches"], "the same launches as the twin")
        closed = [(e.round_idx, e.region) for e in hs.bus.events_of(RegionClosed)]
        folded = [(e.round_idx, e.region) for e in hs.bus.events_of(PartialFolded)]
        want_events = [(r, rid) for r in range(1, HIER_ROUNDS + 1) for rid in regions]
        check(closed == want_events and folded == want_events,
              "RegionClosed and PartialFolded in region order every round")
        reps = hs.fold_reports
        check(reps[1].rerequested == [ids[1]]
              and reps[1].region_reports["aws_us_east_1"].rerequested == [ids[1]]
              and all(not r.rerequested for i, r in enumerate(reps) if i != 1),
              "round 2 re-requests femnist_client_1 in aws_us_east_1, and only then")
        check(hier["carry"] == [("gcp_us_central1", ids[3])],
              f"femnist_client_3 parked in gcp_us_central1 after round 3, got {hier['carry']}")
        check(reps[2].carried_over == [ids[3]] and reps[3].carried_in == [ids[3]]
              and reps[3].region_reports["gcp_us_central1"].carried_in == [ids[3]],
              "round 4 folds the parked update in gcp_us_central1")
        fr = runs["flat"]["server"].fold_reports
        check([r.rerequested for r in fr] == [r.rerequested for r in reps]
              and [r.carried_over for r in fr] == [r.carried_over for r in reps]
              and [r.carried_in for r in fr] == [r.carried_in for r in reps],
              "the twin re-requests and carries the same silos")
        folder = hs.coordinator.folder
        check(folder.n_collectives == HIER_ROUNDS, f"one all-reduce a round, got "
              f"{folder.n_collectives}")
        check(all(t.is_cuda for t in tree_leaves(hier["run"].final_params)),
              "every parameter on cuda")
        out.update(rounds=rows, round1_ratio=r1, fold_ratios=fold_ratios,
                   final_rel_l2=final_rel, losses=losses,
                   launches=hier["launches"], twin_launches=flat["launches"],
                   wall_s=hier["wall_s"], twin_wall_s=flat["wall_s"],
                   n_collectives=folder.n_collectives,
                   twin_rounds=[{"round": r.round_idx, "train_s": r.train_time_s,
                                 "fold_s": r.agg_time_s, "eval_s": r.eval_time_s}
                                for r in flat["run"].rounds])
        del runs, hier, flat, hs, server, spans, shadow
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()

    sampler = CohortSampler(size=4, seed=9)
    server = HierarchicalFLServer(clients, params0, regions=regions, cohort=4, cohort_seed=9,
                                  compression="int8", device="cuda")
    zero_counts()
    server.run(2)
    cohort_launches = counts()
    folded = [sorted(rep.fold_times) for rep in server.fold_reports]
    want = [sorted(sampler.sample(r, ids)) for r in (1, 2)]
    say(f"[hierarchy] cohort=4, cohort_seed=9: folded {folded}; population after "
        f"{[c.client_id for c in server.clients]}; launches {_nonzero(cohort_launches)}")
    check(folded == want, f"each round folds CohortSampler(size=4, seed=9)'s cohort {want}")
    check([c.client_id for c in server.clients] == ids, "the population is restored")
    check(cohort_launches["dequant_fold"] == 8, "one dequant_fold a cohort silo a round")
    out.update(cohort_folded=folded, cohort_launches=cohort_launches)
    del server, clients, params0
    torch.cuda.empty_cache()
    return out


def phase_hierarchy_lora():
    """Federated LoRA through the hierarchy: olmo-1b at full width and
    LORA_LAYERS of its 16 layers (``_lora_setup``, as
    ``phase_lora_rounds``), LORA_SILOS silos in two regions, int8 adapter
    deltas, HIER_LORA_ROUNDS rounds, the LoRA schema, the sequential
    parent; a flat ``AsyncFLServer`` twin.  The frozen base must come back
    bit-equal every round, the adapters within 1e-6 abs + rel of the twin
    after round 1, the silos' adapter frames as many bytes as the twin's,
    ``dequant_fold`` launched as often as in the twin, and the flash
    kernels as a round's training and evaluation on the card need."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_silos
    from repro_torch.federated import AsyncFLServer, HierarchicalFLServer
    from repro_torch.launch.steps import make_optimizer_for
    from repro_torch.models.fl_models import lora_adapter_schema
    from repro_torch.utils.tree import keystr, tree_flatten_with_path

    cfg = get_config("olmo-1b").with_overrides(n_layers=LORA_LAYERS).with_lora(2)
    silos = make_lm_silos(LORA_SILOS, cfg.vocab_size, TRAIN_S, [(4, 2)] * LORA_SILOS, seed=0)
    _, params0, clients = _lora_setup(cfg, "cuda", 0, 1, silos, make_optimizer_for)
    leaves0 = [(keystr(p), t.clone()) for p, t in tree_flatten_with_path(params0)[0]]
    ids = [c.client_id for c in clients]
    regions = {"region_a": ids[:2], "region_b": ids[2:]}
    schema = lora_adapter_schema()
    L = cfg.n_layers
    per_round = {"flash_attention": LORA_SILOS * (2 + 1) * L,
                 "flash_attention_bwd": LORA_SILOS * 2 * L, "dequant_fold": LORA_SILOS}
    runs = {}
    for name in ("hierarchy", "flat"):
        adapters = {}

        def hook(r, params, adapters=adapters, name=name):
            for (k, t0), (p, t) in zip(leaves0, tree_flatten_with_path(params)[0]):
                check(keystr(p) == k, "leaf order")
                if ".lora_" not in k:
                    check(torch.equal(t, t0), f"{name} round {r}: base leaf {k} bit-equal")
                elif r == 1:
                    adapters[k] = t.clone()
            return None

        cls = HierarchicalFLServer if name == "hierarchy" else AsyncFLServer
        extra = {"regions": regions} if name == "hierarchy" else {}
        server = cls(clients, params0, schema=schema, compression="int8",
                     post_round_hook=hook, device="cuda", **extra)
        zero_counts()
        t0 = time.monotonic()
        run = server.run(HIER_LORA_ROUNDS)
        torch.cuda.synchronize()
        runs[name] = {"server": server, "run": run, "launches": counts(),
                      "wall_s": time.monotonic() - t0, "adapters": adapters}
    hier, flat = runs["hierarchy"], runs["flat"]
    worst = max(((hier["adapters"][k] - flat["adapters"][k]).abs()
                 / (1e-6 + 1e-6 * flat["adapters"][k].abs())).max().item()
                for k in flat["adapters"])
    parent_bytes = sum(p.wire_bytes for rep in hier["server"].fold_reports for p in rep.partials)
    silo_wire = hier["server"].agg_engine.stats.total_wire_bytes - parent_bytes
    twin_wire = flat["server"].agg_engine.stats.total_wire_bytes
    want_launches = dict.fromkeys(KERNELS, 0) | {
        k: n * HIER_LORA_ROUNDS for k, n in per_round.items()}
    for rec, rep in zip(hier["run"].rounds, hier["server"].fold_reports):
        say(f"[hierarchy] lora round {rec.round_idx}: loss {rec.metrics['loss']:.4f}; train "
            f"{rec.train_time_s:.3f} s, fold {rec.agg_time_s:.4f} s (parent "
            f"{rep.parent_fold_s * 1e3:.3f} ms), eval {rec.eval_time_s:.3f} s; partials "
            f"{sum(p.wire_bytes for p in rep.partials):,} B")
    say(f"[hierarchy] lora against the flat twin: adapters after round 1 max |da| / (1e-6 + "
        f"1e-6 |a|) {worst:.3f} (<= 1); silos' adapter frames {silo_wire:,} B against "
        f"{twin_wire:,} B; launches {_nonzero(hier['launches'])} against "
        f"{_nonzero(flat['launches'])}; wall {hier['wall_s']:.1f} s against {flat['wall_s']:.1f} s")
    check(worst <= 1.0, "adapters within 1e-6 abs + rel of the flat twin after round 1")
    check(silo_wire == twin_wire > 0, "the silos' adapter wire bytes equal the twin's")
    check(hier["launches"] == flat["launches"] == want_launches,
          f"hierarchy and twin launch {want_launches}")
    out = {"adapter_ratio": worst, "silo_wire_bytes": silo_wire, "twin_wire_bytes": twin_wire,
           "launches": hier["launches"], "twin_launches": flat["launches"],
           "wall_s": hier["wall_s"], "twin_wall_s": flat["wall_s"],
           "losses": [(h.metrics["loss"], f.metrics["loss"])
                      for h, f in zip(hier["run"].rounds, flat["run"].rounds)]}
    del runs, hier, flat, params0, clients, leaves0
    torch.cuda.empty_cache()
    return out


def phase_stacked_reduce():
    """``fedavg_stacked`` over a stack of 4 FEMNIST trees at the paper's
    width (fp32, leaves with a leading axis of 4: 4 x 656.7 MB): one
    ``fedavg_reduce`` launch over the engine's padded (4, L) layout, each
    leaf within 2e-5 of the plain weighted mean of the same stack."""
    import torch
    from repro_torch.federated import fedavg_stacked
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = FemnistConfig()
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in range(4)]
    stacked = tree_map(lambda *ts: torch.stack(ts),
                       *[init_femnist_cnn(g, cfg, "cuda") for g in gens])
    w = torch.tensor([796.0, 1050.0, 912.0, 860.0], device="cuda")
    zero_counts()
    t0 = time.monotonic()
    got = fedavg_stacked(stacked, w)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = counts()
    wn = w / w.sum()
    err = max((g - (s * wn.view(-1, *[1] * (s.dim() - 1))).sum(0)).abs().max().item()
              for g, s in zip(tree_leaves(got), tree_leaves(stacked)))
    n = sum(t[0].numel() for t in tree_leaves(stacked))
    say(f"[stacked] fedavg_stacked over 4 FEMNIST trees (L = {n:,}): {wall * 1e3:.1f} ms "
        f"host with the (4, L) copy; max|stacked - plain| {err:.3e} (tol 2e-5); launches "
        f"{_nonzero(launches)}")
    check(n == PAPER_L, "the paper's FEMNIST width")
    check(err <= 2e-5, "fedavg_stacked within 2e-5 of the plain weighted mean")
    check(launches == dict.fromkeys(KERNELS, 0) | {"fedavg_reduce": 1},
          "exactly one fedavg_reduce launch")
    del stacked, got
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err, "wall_s": wall}


# ---------------------------------------------------------------------------
# Pod-parallel FedAvg, meshes and placement
# ---------------------------------------------------------------------------

POD_N = 2               # pods (FL silos): the reference's multi-pod mesh has 2
POD_LOCAL_STEPS = 4     # local steps a round (the reference dry-run's LOCAL_STEPS)
POD_ROUNDS = 2
POD_BATCH = {"olmo-1b": 4, "mamba2-130m": 8}   # global batches: per-pod (2, 2048) and (4, 2048)
POD_CUT = None          # olmo-1b's depth cut, were its round not to fit on the card: none, full depth


def phase_pod_mesh():
    """Meshes and placement on an NCCL process group of one: a
    ``make_host_mesh(data=1, model=1)`` ("data", "model") ``DeviceMesh`` and
    a ``pod=1`` one, a mesh of the wrong size refused; olmo-1b's parameters
    (full width, bf16, seed 0) placed by ``param_specs`` through
    ``distribute``, each rank-local shard bit-equal to the tensor it came
    from; ``batch_iterator`` yielding DTensors sharded on "data" whose
    local data equals the iterator's without a mesh.  The group is
    destroyed at the end, before the live phases spawn processes."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, batch_iterator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.sharding import axis_sizes, distribute, param_specs
    from repro_torch.utils.tree import tree_leaves

    with _pod_of_one():
        mesh = make_host_mesh(data=1, model=1)
        pod_mesh = make_host_mesh(pod=1)
        refused = False
        try:
            make_host_mesh(data=2)
        except ValueError:
            refused = True
        check(mesh.device_type == "cuda" and axis_sizes(mesh) == {"data": 1, "model": 1},
              "a (data=1, model=1) mesh on the card")
        check(axis_sizes(pod_mesh) == {"pod": 1, "data": 1, "model": 1}, "a pod=1 mesh")
        check(refused, "a data=2 mesh on a group of one raises")
        cfg = get_config("olmo-1b")
        params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        specs = param_specs(params, cfg, mesh)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        placed = distribute(params, mesh, specs)
        torch.cuda.synchronize()
        place_s = time.monotonic() - t0
        leaves, dts = tree_leaves(params), tree_leaves(placed)
        exact = len(leaves) == len(dts) and all(
            isinstance(d, DTensor) and d.to_local().is_cuda and _bit_equal([d.to_local()], [t])
            for t, d in zip(leaves, dts))
        sharded = sum(any(p.is_shard() for p in d.placements) for d in dts)
        n, n_leaves = sum(t.numel() for t in leaves), len(leaves)
        del placed, params, leaves, dts
        it = batch_iterator(SyntheticLM(cfg.vocab_size, TRAIN_S, seed=0), TRAIN_B, seed=0, mesh=mesh)
        plain = batch_iterator(SyntheticLM(cfg.vocab_size, TRAIN_S, seed=0), TRAIN_B, seed=0)
        b, want = next(it), next(plain)
        batch_ok = all(isinstance(b[k], DTensor) and list(b[k].placements) == [Shard(0), Replicate()]
                       and torch.equal(b[k].to_local(), want[k]) and want[k].is_cuda
                       for k in ("tokens", "labels"))
    torch.cuda.empty_cache()
    say(f"[pod-mesh] NCCL group of one: meshes {mesh.mesh_dim_names} {tuple(mesh.shape)} and "
        f"{pod_mesh.mesh_dim_names} {tuple(pod_mesh.shape)}, data=2 refused: {refused}; olmo-1b "
        f"({n:,} parameters, {n_leaves} leaves, {sharded} with a Shard placement) distributed in {place_s * 1e3:.1f} ms, every "
        f"local shard bit-equal: {exact}; batch_iterator DTensors on data: {batch_ok}")
    check(exact, "distribute keeps every olmo-1b leaf bit-equal")
    check(batch_ok, "batch_iterator yields DTensors sharded on data, equal to the plain batches")
    return {"distribute_s": place_s, "params": n, "sharded_leaves": sharded, "exact": exact,
            "batch_ok": batch_ok}


class _barrier_clock:
    """Within ``with``: host clock marks around the pod step's
    ``fedavg_stacked`` (a synchronize first, so the pods' local work is
    done) and around its ``fedavg_reduce`` launch, which CUDA events also
    time on the card."""

    def __enter__(self):
        import torch

        self.pf = sys.modules["repro_torch.federated.pod_fedavg"]
        self.ae = sys.modules["repro_torch.federated.agg_engine"]
        self.stacked, self.reduce = self.pf.fedavg_stacked, self.ae.fedavg_reduce

        def stacked(*a, **kw):
            torch.cuda.synchronize()
            self.enter = time.monotonic()
            out = self.stacked(*a, **kw)
            torch.cuda.synchronize()
            self.exit = time.monotonic()
            return out

        def reduce(*a, **kw):
            torch.cuda.synchronize()
            self.reduce_in = time.monotonic()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.reduce(*a, **kw)
            end.record()
            end.synchronize()
            self.reduce_ms = start.elapsed_time(end)
            self.reduce_out = time.monotonic()
            return out

        self.pf.fedavg_stacked, self.ae.fedavg_reduce = stacked, reduce
        return self

    def __exit__(self, *exc):
        self.pf.fedavg_stacked, self.ae.fedavg_reduce = self.stacked, self.reduce
        return False


def _pod_batches(cfg, ds, global_batch: int, rngs, local_steps: int = POD_LOCAL_STEPS,
                 device="cuda") -> dict:
    """One round's batches, shaped by ``pod_batch_shape``: pod ``p`` draws
    its local steps' sequences from its own generator (``rngs[p]``, seeded
    100 + p: non-IID silos, as ``examples/pod_fedavg_train.py`` makes them)."""
    import numpy as np
    import torch
    from repro_torch.federated import pod_batch_shape

    shape = pod_batch_shape(cfg, POD_N, local_steps, global_batch, ds.seq_len)["tokens"][0]
    toks, labels = np.empty(shape, np.int32), np.empty(shape, np.int32)
    for p in range(POD_N):
        for s in range(local_steps):
            toks[p, s], labels[p, s] = ds.sample(rngs[p], shape[2])
    return {"tokens": torch.from_numpy(toks).to(device), "labels": torch.from_numpy(labels).to(device)}


def _pods_bit_equal(stacked) -> bool:
    from repro_torch.utils.tree import tree_leaves

    return all(_bit_equal([x[0]], [x[i]]) for x in tree_leaves(stacked) for i in range(1, x.shape[0]))


def _pod_round(arch: str) -> dict:
    """``arch`` at full width and depth (bf16, ``make_optimizer_for``'s
    AdamW, random weights from seed 0): POD_N pods, POD_LOCAL_STEPS local
    steps a round, POD_ROUNDS rounds of ``make_fl_round_step``.  First the
    sequential twin of round 1 (each pod trains alone through
    ``make_train_step`` from the same start, ``fedavg_stacked`` folds the
    finals, held against the plain per-leaf ``fedavg``); only its average
    is kept, on the host.  Each round: its wall time split into the pods'
    local steps and the barrier (flatten, the ``fedavg_reduce`` launch by
    CUDA events beside its bound, unflatten, broadcast), the launches, the
    pods bit-equal after the barrier; round 1 bit-equal to the twin."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.federated import (
        fedavg, fedavg_stacked, init_pod_state, make_fl_round_step, make_train_step)
    from repro_torch.launch.steps import make_optimizer_for
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config(arch)
    if arch == "olmo-1b" and POD_CUT:
        cfg = cfg.with_overrides(**POD_CUT)
    model, opt = get_model(cfg), make_optimizer_for(cfg)
    # olmo-1b's round needs ~69.5 GiB of the card's 79.18.
    torch.cuda.empty_cache()
    entry = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sp, so = init_pod_state(model, opt, torch.Generator(device="cuda").manual_seed(0), POD_N, "cuda")
    L = sum(x[0].numel() for x in tree_leaves(sp))
    ds = SyntheticLM(cfg.vocab_size, TRAIN_S, seed=0)
    rngs = [np.random.default_rng(100 + p) for p in range(POD_N)]
    batches = [_pod_batches(cfg, ds, POD_BATCH[arch], rngs) for _ in range(POD_ROUNDS)]
    w = torch.ones(POD_N)
    steps = POD_N * POD_LOCAL_STEPS
    only = (dict.fromkeys(KERNELS, 0) | {"fedavg_reduce": 1}
            | {k: v * steps for k, v in (_launches(cfg) | _launches(cfg, True)).items()})
    tag = f"[pod] {arch} bf16"

    # The sequential twin of round 1.
    zero_counts()
    t0 = time.monotonic()
    train = make_train_step(model, opt)
    finals = []
    for pod in range(POD_N):
        p = tree_map(lambda x: x[pod], sp)
        o = type(so)(so.step, *(tree_map(lambda x: x[pod], t) for t in so[1:]))
        for s in range(POD_LOCAL_STEPS):
            p, o, _ = train(p, o, {k: v[pod, s] for k, v in batches[0].items()})
        finals.append(p)
        del p, o
    stacked = tree_map(lambda *xs: torch.stack(xs), *finals)
    twin = fedavg_stacked(stacked, w)
    del stacked
    oracle = fedavg(finals, [1.0] * POD_N)
    oracle_err = max(rel_l2(a, b) for a, b in zip(tree_leaves(twin), tree_leaves(oracle)))
    oracle_tol = 2e-2 if tree_leaves(twin)[0].dtype == torch.bfloat16 else 2e-5
    twin = [t.cpu() for t in tree_leaves(twin)]
    del finals, oracle
    torch.cuda.synchronize()
    twin_s, twin_launches = time.monotonic() - t0, counts()
    torch.cuda.empty_cache()

    step = make_fl_round_step(model, opt, POD_LOCAL_STEPS)
    params, opt_state = sp, so
    del sp, so
    rows, twin_equal = [], None
    bound_ms = 3 * 4 * L / HBM_BYTES_PER_S * 1e3   # (POD_N=2, L) fp32 read, (L,) written
    for r in range(POD_ROUNDS):
        zero_counts()
        with _barrier_clock() as clk:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            params, opt_state, loss = step(params, opt_state, batches[r])
            torch.cuda.synchronize()
            t1 = time.monotonic()
        launches = counts()
        synced = _pods_bit_equal(params)
        if r == 0:
            twin_equal = all(_bit_equal([a[0].cpu()], [b]) for a, b in zip(tree_leaves(params), twin))
        row = {"round": r + 1, "loss": float(loss), "wall_s": t1 - t0,
               "local_s": clk.enter - t0, "barrier_s": t1 - clk.enter,
               "flatten_s": clk.reduce_in - clk.enter, "reduce_ms": clk.reduce_ms,
               "unflatten_s": clk.exit - clk.reduce_out, "broadcast_s": t1 - clk.exit,
               "launches": launches, "pods_bit_equal": synced, "step": opt_state.step}
        rows.append(row)
        say(f"{tag} round {r + 1}: loss {row['loss']:.4f}; wall {row['wall_s']:.3f} s = local steps "
            f"{row['local_s']:.3f} s + barrier {row['barrier_s'] * 1e3:.1f} ms (flatten "
            f"{row['flatten_s'] * 1e3:.1f} ms, fedavg_reduce {row['reduce_ms']:.4f} ms by CUDA events "
            f"against its bound {bound_ms:.4f} ms ({bound_ms / row['reduce_ms'] * 100:.1f} %), "
            f"unflatten {row['unflatten_s'] * 1e3:.1f} ms, broadcast {row['broadcast_s'] * 1e3:.1f} ms); "
            f"launches {_nonzero(launches)}; pods bit-equal after the barrier: {synced}")
    peak = torch.cuda.max_memory_allocated()
    del params, opt_state, batches, twin
    torch.cuda.empty_cache()
    say(f"{tag}: {POD_N} pods x {POD_LOCAL_STEPS} local steps, per-pod batch "
        f"({POD_BATCH[arch] // POD_N}, {TRAIN_S}), L = {L:,} ({cfg.n_layers} layers); sequential "
        f"twin {twin_s:.2f} s, launches {_nonzero(twin_launches)}, its fedavg_stacked against the "
        f"plain per-leaf fedavg {oracle_err:.3e} relative L2 (tol {oracle_tol:g}); round 1 bit-equal "
        f"to the twin: {twin_equal}; max_memory_allocated {peak / 2**30:.2f} GiB of "
        f"{torch.cuda.mem_get_info(0)[1] / 2**30:.2f} GiB ({entry / 2**30:.2f} GiB held on entry)")
    check(twin_launches == only, f"{arch} twin launches {only}, got {_nonzero(twin_launches)}")
    check(oracle_err <= oracle_tol, f"{arch} fedavg_stacked within {oracle_tol:g} of fedavg")
    check(twin_equal, f"{arch} round 1 bit-equal to the sequential twin")
    for row in rows:
        check(row["launches"] == only, f"{arch} round {row['round']} launches {only}")
        check(row["pods_bit_equal"], f"{arch} pods bit-equal after round {row['round']}")
        check(math.isfinite(row["loss"]), f"{arch} round {row['round']} loss finite")
        check(row["step"] == POD_LOCAL_STEPS * row["round"], f"{arch} optimizer step count")
    check(rows[-1]["loss"] < rows[0]["loss"], f"{arch} round {POD_ROUNDS}'s loss below round 1's")
    return {"params": L, "layers": cfg.n_layers, "rounds": rows, "twin_s": twin_s,
            "oracle_rel_l2": oracle_err, "twin_bit_equal": twin_equal, "bound_ms": bound_ms,
            "peak_bytes": peak, "entry_bytes": entry, "launches": rows[0]["launches"]}


def _pod_round_card_vs_cpu() -> dict:
    """Reduced olmo-1b in fp32: one pod round (POD_N pods, 2 local steps,
    per-pod batch (2, 64)) on the card (kernels) and on the CPU (plain
    versions) from the same weights: loss within 1e-4 relative, every
    parameter leaf within 1e-4 relative L2, the kernels launched on the
    card only."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.federated import init_pod_state, make_fl_round_step
    from repro_torch.launch.steps import make_optimizer_for
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("olmo-1b").reduced().with_overrides(dtype="float32", param_dtype="float32")
    model, opt = get_model(cfg), make_optimizer_for(cfg)
    sp, _ = init_pod_state(model, opt, torch.Generator().manual_seed(5), POD_N, "cpu")
    rngs = [np.random.default_rng(100 + p) for p in range(POD_N)]
    batch = _pod_batches(cfg, SyntheticLM(cfg.vocab_size, 64, seed=0), 2 * POD_N, rngs,
                         local_steps=2, device="cpu")
    runs = {}
    for device in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(device), sp)
        zero_counts()
        new, _, loss = make_fl_round_step(model, opt, 2)(
            p, opt.init(p), {k: v.to(device) for k, v in batch.items()})
        runs[device] = ([t.cpu() for t in tree_leaves(new)], float(loss), counts())
    (cp, cl, cn), (pp, pl, pn) = runs["cuda"], runs["cpu"]
    worst = max(rel_l2(a, b) for a, b in zip(cp, pp))
    only = dict.fromkeys(KERNELS, 0)
    want = only | {"fedavg_reduce": 1} | {k: v * POD_N * 2 for k, v in
                                          (_launches(cfg) | _launches(cfg, True)).items()}
    ok = abs(cl - pl) <= 1e-4 * abs(pl) and worst <= 1e-4 and cn == want and pn == only
    say(f"[reference] reduced olmo-1b fp32 pod round ({POD_N} pods x 2 steps), card against CPU: "
        f"loss {cl:.6f} / {pl:.6f}, worst leaf relative L2 {worst:.3e} (tol 1e-4); launches card "
        f"{_nonzero(cn)}, cpu {_nonzero(pn)} {'ok' if ok else 'FAIL'}")
    check(ok, "reduced olmo-1b pod round: card agrees with the CPU")
    return {"loss": (cl, pl), "worst_rel_l2": worst, "launches": _nonzero(cn)}


def phase_pod_round():
    """The pod-parallel FedAvg round (``federated/pod_fedavg.py``) for
    olmo-1b and mamba2-130m at full width and depth (``_pod_round``), then
    a reduced olmo-1b pod round on the card against the CPU."""
    return {"olmo-1b": _pod_round("olmo-1b"), "mamba2-130m": _pod_round("mamba2-130m"),
            "reference": _pod_round_card_vs_cpu()}


# ---------------------------------------------------------------------------
# The live transport and the chaos harness
# ---------------------------------------------------------------------------

LIVE_ROUNDS = 3         # phase A's rounds: round 1 clean (traced, replayed), 2 and 3 faulted
LIVE_HANG_S = 600.0     # a hung silo's own bound; the heartbeats find it first
LIVE_REPLY_TIMEOUT_S = 600.0
LIVE_PROC_ROUNDS = 2    # phase B's rounds
SOAK_HB = {"heartbeat_interval_s": 0.2, "heartbeat_timeout_s": 2.0}


def _gil_probe(fn) -> tuple:
    """``fn()``, its wall time, and the longest time a ticker thread that
    asks for the GIL every millisecond waited meanwhile: how long ``fn``
    can keep another Python thread (a worker's PONG) from running."""
    import threading

    gaps, stop = [0.0], threading.Event()

    def tick():
        last = time.monotonic()
        while not stop.is_set():
            time.sleep(0.001)
            now = time.monotonic()
            gaps[0] = max(gaps[0], now - last)
            last = now

    t = threading.Thread(target=tick, daemon=True)
    t.start()
    time.sleep(0.01)
    gaps[0] = 0.0
    t0 = time.monotonic()
    out = fn()
    wall = time.monotonic() - t0
    stop.set()
    t.join()
    return out, wall, gaps[0]


def _recording_transport():
    """A ``SocketTransport`` that keeps every frame it sends (kind, silo,
    payload bytes, seconds in ``sendall``, start) and every message it
    receives (kind, silo, round, payload and wire bytes, time, and the
    silo's reported train or eval time), and each silo's hello times."""
    from repro_torch.federated import SocketTransport

    class RecordingTransport(SocketTransport):
        def __init__(self):
            super().__init__(send_timeout_s=120.0)
            self.sent, self.received, self.joined = [], [], {}

        def send(self, client_id, header, payload=b""):
            t0 = time.monotonic()
            n = super().send(client_id, header, payload)
            self.sent.append({"kind": header.get("kind"), "cid": client_id,
                              "round": header.get("round_idx"), "payload": len(payload),
                              "wire": n, "s": time.monotonic() - t0, "t": t0})
            return n

        def poll(self, timeout_s):
            events = super().poll(timeout_s)
            now = time.monotonic()
            for ev in events:
                if ev.kind == "joined":
                    self.joined.setdefault(ev.client_id, []).append(now)
                elif ev.kind == "message":
                    h = ev.header
                    self.received.append({
                        "kind": h.get("kind"), "cid": ev.client_id, "round": h.get("round_idx"),
                        "payload": len(ev.payload), "wire": ev.wire_bytes, "t": now,
                        "compute_s": h.get("train_time_s", h.get("eval_time_s"))})
            return events

    return RecordingTransport()


class _Spans:
    """Host-clock spans of module functions on the live path, patched in
    for a phase and restored after: (name, thread, start, seconds)."""

    def __init__(self):
        self.spans, self._undo = [], []

    def wrap(self, owner, attr: str, name: str) -> None:
        import threading

        orig = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return orig(*args, **kwargs)
            finally:
                self.spans.append((name, threading.current_thread().name, t0,
                                   time.monotonic() - t0))

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, orig))

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def _fold_device_timer():
    """Wrap the aggregator's ``dequant_fold`` call (the kernel wrapper,
    which still counts its launches) in CUDA events: each fold's device
    time.  Returns (events, undo)."""
    import torch
    from repro_torch.federated import agg_engine

    orig, events = agg_engine.dequant_fold, []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kwargs)
        end.record()
        events.append((time.monotonic(), start, end))
        return out

    agg_engine.dequant_fold = timed

    def undo():
        agg_engine.dequant_fold = orig

    return events, undo


def _device_busy(prof, n_top: int = 4) -> tuple:
    """The union of the traced kernels' intervals (s), their count, and
    the ``n_top`` kernels with the most device time (name, ms)."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by_name = 0.0, -math.inf, {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[e.name] = by_name.get(e.name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return busy * 1e-6, len(kernels), [(name, t / 1e3) for name, t in top]


def _round_splits(rec, spans: _Spans, folds: list, round_t0: dict, records) -> list:
    """Each round's wall time split: the driver's serialization of
    s_msg_train / s_msg_aggreg, its sends (seconds in ``sendall``, bytes,
    GB/s), the c_msg_train bytes back, the silos' reported train time
    (longest), their deserialization, encode and frame (longest, where the
    silos are threads of this process), the fold (host ``agg_time_s`` and
    the kernels' device ms) and the evaluation phase."""
    starts = sorted(round_t0.items())

    def round_of(t):
        r = None
        for idx, t0 in starts:
            if t >= t0:
                r = idx
        return r

    out = []
    for rr in records:
        r = rr.round_idx
        mine = [s for s in spans.spans if round_of(s[2]) == r]
        driver_ser = [s[3] for s in mine if s[0] == "serialize_pytree" and s[1] == "MainThread"]
        silo = {k: max([s[3] for s in mine if s[0] == k and s[1] != "MainThread"], default=0.0)
                for k in ("deserialize_pytree", "encode", "serialize_update")}
        sends = {k: [m for m in rec.sent if m["kind"] == k and m["round"] == r]
                 for k in ("s_msg_train", "s_msg_aggreg")}
        back = [m for m in rec.received if m["kind"] == "c_msg_train" and m["round"] == r]
        fold_ms = [a.elapsed_time(b) for t, a, b in folds if round_of(t) == r]
        row = {
            "round": r, "wall_s": rr.train_time_s + rr.eval_time_s + rr.checkpoint_time_s,
            "train_phase_s": rr.train_time_s, "eval_phase_s": rr.eval_time_s,
            "serialize_s_msg_train_s": driver_ser[0] if driver_ser else None,
            "serialize_s_msg_aggreg_s": driver_ser[1] if len(driver_ser) > 1 else None,
            "silo_deserialize_s": silo["deserialize_pytree"], "silo_encode_s": silo["encode"],
            "silo_frame_s": silo["serialize_update"],
            "silo_train_s": max([m["compute_s"] or 0.0 for m in back], default=0.0),
            "c_msg_train_bytes": sum(m["payload"] for m in back), "c_msg_train_n": len(back),
            "agg_time_s": rr.agg_time_s, "fold_device_ms": fold_ms,
        }
        for k, ms in sends.items():
            nbytes, secs = sum(m["payload"] for m in ms), sum(m["s"] for m in ms)
            row[f"{k}_bytes"], row[f"{k}_send_s"], row[f"{k}_n"] = nbytes, secs, len(ms)
            row[f"{k}_gb_s"] = nbytes / secs / 1e9 if secs > 0 else None
        out.append(row)
    return out


def _say_splits(tag: str, rows: list) -> None:
    for row in rows:
        def f(x, fmt=".3f"):
            return "n/a" if x is None else format(x, fmt)
        say(f"{tag} round {row['round']}: wall {row['wall_s']:.3f} s = train phase "
            f"{row['train_phase_s']:.3f} s (serialize s_msg_train "
            f"{f(row['serialize_s_msg_train_s'])} s; send {row['s_msg_train_n']} x "
            f"{row['s_msg_train_bytes'] / max(row['s_msg_train_n'], 1) / 1e6:.1f} MB in "
            f"{row['s_msg_train_send_s']:.3f} s = {f(row['s_msg_train_gb_s'], '.2f')} GB/s; "
            f"silos: deserialize {row['silo_deserialize_s']:.3f} s, train "
            f"{row['silo_train_s']:.3f} s, encode {row['silo_encode_s']:.3f} s, frame "
            f"{row['silo_frame_s']:.3f} s (longest); {row['c_msg_train_n']} c_msg_train = "
            f"{row['c_msg_train_bytes'] / 1e6:.1f} MB back; fold agg_time_s "
            f"{row['agg_time_s']:.3f} s, device "
            + "+".join(f"{ms:.3f}" for ms in row["fold_device_ms"]) + " ms) + eval phase "
            f"{row['eval_phase_s']:.3f} s (serialize s_msg_aggreg "
            f"{f(row['serialize_s_msg_aggreg_s'])} s; send {row['s_msg_aggreg_n']} x "
            f"{row['s_msg_aggreg_bytes'] / max(row['s_msg_aggreg_n'], 1) / 1e6:.1f} MB in "
            f"{row['s_msg_aggreg_send_s']:.3f} s = {f(row['s_msg_aggreg_gb_s'], '.2f')} GB/s)")


def _femnist_live_silos():
    """The five silos of ``femnist_application()``, named and sized as its
    clients (796-1050 train and 90-118 test samples)."""
    import dataclasses

    from repro_torch.core import femnist_application
    from repro_torch.data import make_classification_silos

    app = femnist_application()
    sizes = [(c.n_train_samples, c.n_test_samples) for c in app.clients]
    silos = make_classification_silos(len(sizes), 62, (28, 28, 1), sizes, seed=0)
    return [dataclasses.replace(s, client_id=c.client_id) for s, c in zip(silos, app.clients)]


def phase_live_round():
    """The live transport at the paper's FEMNIST width on the card: the
    five silos of ``femnist_application()`` as ``ThreadWorkerPool``
    workers behind ``SocketTransport`` on loopback, int8 updates folded
    by ``dequant_fold`` in this process, 3 rounds of ``LiveRoundDriver``
    with a ``FaultPlan``: round 2 a crash (re-requested) and a corrupt
    frame, round 3 a revocation (the §4.4 ``DynamicScheduler`` moves the
    silo to another VM) and a hang (found by heartbeats).  The heartbeat
    bound is sized from this run's measurements: the GIL hold of
    serializing and deserializing the 656.7 MB tree, and the time to
    dispatch it to five silos.  Round 1 is traced (the device's idle
    share) and replayed in process (``AsyncFLServer`` with a
    ``RecordedSchedule`` of its arrivals): params within 2e-5, equal
    ``chaos_signature``."""
    import dataclasses
    import itertools
    import socket
    import threading

    import torch
    from repro_torch.core import (
        Assignment, CostModel, DynamicScheduler, cloudlab_environment, femnist_application)
    from repro_torch.core.events import RevocationOccurred, RoundDispatched, UpdateArrived
    from repro_torch.federated import (
        AsyncFLServer, ChaosClient, ClientArrival, FaultPlan, FaultSpec, LiveRoundDriver,
        RecordedSchedule, ThreadWorkerPool, chaos_signature, compression, to_cost_model_sizes,
        transport, verify_fault_pairing)
    from repro_torch.federated.compression import compressed_wire_bytes, parse_compression
    from repro_torch.federated.transport import recv_frame, send_frame
    from repro_torch.models.fl_models import FemnistConfig, init_femnist_cnn
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = FemnistConfig()
    params0 = init_femnist_cnn(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    check(sum(t.numel() for t in tree_leaves(params0)) == PAPER_L, "FEMNIST at L = PAPER_L")
    n_silos = len(femnist_application().clients)

    # Sizing the heartbeats: the longest GIL hold the live path's host work
    # imposes on a worker's receive loop, and the dispatch of one round.
    blob, ser_s, ser_gap = _gil_probe(lambda: transport.serialize_pytree(params0))
    _, de_s, de_gap = _gil_probe(lambda: transport.deserialize_pytree(blob, params0))
    a, b = socket.socketpair()
    got = {}
    reader = threading.Thread(target=lambda: got.setdefault("f", recv_frame(b)), daemon=True)
    reader.start()
    _, send_s, send_gap = _gil_probe(
        lambda: send_frame(a, {"kind": "s_msg_train", "round_idx": 1}, blob))
    reader.join()
    a.close()
    b.close()
    check(bytes(got["f"][1]) == blob, "a 656.7 MB frame crosses loopback intact")
    del blob, got

    silos = _femnist_live_silos()
    cids = [s.client_id for s in silos]
    plan = FaultPlan([
        FaultSpec("crash", cids[1], 2), FaultSpec("corrupt_frame", cids[2], 2),
        FaultSpec("revocation", cids[3], 3), FaultSpec("hang", cids[4], 3),
    ], seed=0)

    class TimedChaosClient(ChaosClient):
        """Records when each of its faults fired."""

        def __init__(self, inner):
            super().__init__(inner, plan, hang_s=LIVE_HANG_S)
            self.fired_at = {}

        def _take(self, *kinds):
            f = super()._take(*kinds)
            if f is not None:
                self.fired_at[f.key] = time.monotonic()
            return f

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    opt = make_optimizer("adamw", 1e-4)
    clients = _femnist_clients(cfg, silos, opt, "cuda")

    def warm(c):
        p, state = params0, opt.init(params0)
        for raw in itertools.islice(c.silo.batches(c.batch_size), 3):
            p, state, _ = c._train_step(p, state, c.batch_fn(raw))
        c.evaluate(params0)

    def warm_up():
        # Three train steps and an evaluation of every silo at once, each
        # on a thread as in a round: the first cuDNN and cuBLAS calls of
        # each silo out of the rounds, and the GIL waits five training
        # threads impose.
        threads = [threading.Thread(target=warm, args=(c,)) for c in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    _, warm_s, train_gap = _gil_probe(warm_up)
    gil_hold = max(ser_gap, de_gap, send_gap, train_gap)
    dispatch_s = ser_s + n_silos * send_s
    hb_timeout = 2.0 * dispatch_s + 10.0 * gil_hold
    hb_interval = hb_timeout / 10.0
    say(f"[live] heartbeat sizing at L = {PAPER_L:,}: serialize_pytree {ser_s:.3f} s "
        f"(longest GIL hold {ser_gap * 1e3:.1f} ms), deserialize_pytree {de_s:.3f} s (hold "
        f"{de_gap * 1e3:.1f} ms), one weight frame over loopback {send_s:.3f} s = "
        f"{PAPER_L * 4 / send_s / 1e9:.2f} GB/s (hold {send_gap * 1e3:.1f} ms), the {n_silos} "
        f"silos training at once {warm_s:.3f} s (hold {train_gap * 1e3:.1f} ms); dispatch of {n_silos} ~ {dispatch_s:.3f} s; "
        f"heartbeat_timeout_s = 2 x dispatch + 10 x longest hold = {hb_timeout:.3f} s, "
        f"heartbeat_interval_s {hb_interval:.3f} s")
    wrapped = [TimedChaosClient(c) for c in clients]
    env, app = cloudlab_environment(), femnist_application()
    placement = {"s": Assignment("vm_126", "on_demand")}
    for cid, vm in zip(cids, ("vm_112", "vm_121", "vm_135", "vm_211", "vm_221")):
        placement[cid] = Assignment(vm, "spot")
    placement0 = dict(placement)
    cm = CostModel(cloudlab_environment(), femnist_application(), 0.5)
    estimate = dataclasses.asdict(app.messages)
    rec = _recording_transport()
    driver = LiveRoundDriver(
        ThreadWorkerPool(wrapped, params0, compression="int8", device="cuda"), params0,
        transport=rec, compression="int8", device="cuda",
        reply_timeout_s=LIVE_REPLY_TIMEOUT_S, startup_timeout_s=120.0,
        heartbeat_interval_s=hb_interval, heartbeat_timeout_s=hb_timeout,
        scheduler=DynamicScheduler(CostModel(env, app, 0.5)), placement=placement,
        cost_model=cm, chaos=plan)

    round_t0, snap = {}, {}
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def on_dispatch(ev):
        round_t0[ev.round_idx] = time.monotonic()
        if ev.round_idx == 2:
            torch.cuda.synchronize()
            prof.stop()
            snap["trace_wall_s"] = time.monotonic() - snap["trace_t0"]
            snap["params"] = tree_map(lambda t: t.clone(), driver.params)
            snap["messages"] = dataclasses.asdict(cm.app.messages)

    driver.bus.subscribe(RoundDispatched, on_dispatch)
    spans = _Spans()
    spans.wrap(transport, "serialize_pytree", "serialize_pytree")
    spans.wrap(transport, "deserialize_pytree", "deserialize_pytree")
    spans.wrap(compression.ClientCompressor, "encode", "encode")
    spans.wrap(compression, "serialize_update", "serialize_update")
    folds, undo_folds = _fold_device_timer()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.monotonic()
    try:
        with driver:
            # Round 1 is traced from just before its dispatch to round 2's
            # (the profiler's start stays out of the round's heartbeat clock).
            torch.cuda.synchronize()
            prof.start()
            snap["trace_t0"] = time.monotonic()
            res = driver.run(LIVE_ROUNDS)
    finally:
        spans.restore()
        undo_folds()
    wall = time.monotonic() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    busy_s, n_kernels, top = _device_busy(prof)
    trace = driver.trace
    rows = _round_splits(rec, spans, folds, round_t0, res.rounds)
    _say_splits("[live]", rows)

    # Faults: paired, the revoked silo moved, crash -> re-arrival and hang -> detection.
    pairing = verify_fault_pairing(plan, trace)
    replaced = [e for e in trace if type(e).__name__ == "VMReplaced"]
    say(f"[live] {LIVE_ROUNDS} rounds in {wall:.1f} s; fault pairing "
        + ", ".join(f"{k[0]} {k[1]} r{k[2]}: {v}" for k, v in pairing.items())
        + "; VM replacements " + ", ".join(f"{e.task} {e.old_vm} -> {e.new_vm} ({e.market})"
                                          for e in replaced))
    fired = {}
    for w in wrapped:
        fired.update(w.fired_at)

    def at(ev):  # an engine event's wall time: its offset from its round's dispatch
        return round_t0[ev.round_idx] + ev.time_s

    crash_key = ("crash", cids[1], 2, "train")
    rearrive = [e for e in trace if isinstance(e, UpdateArrived) and e.task == cids[1]
                and e.round_idx == 2 and e.attempt >= 2]
    crash_to_rearrival = at(rearrive[0]) - fired[crash_key] if rearrive else None
    hang_key = ("hang", cids[4], 3, "train")
    detected = [e for e in trace if isinstance(e, RevocationOccurred) and e.task == cids[4]
                and e.round_idx == 3]
    hang_to_detection = at(detected[0]) - fired[hang_key] if detected else None
    say(f"[live] crash of {cids[1]} in round 2 to its re-arrival: "
        f"{crash_to_rearrival if crash_to_rearrival is None else f'{crash_to_rearrival:.3f}'} s; "
        f"hang of {cids[4]} in round 3 to its detection: "
        f"{hang_to_detection if hang_to_detection is None else f'{hang_to_detection:.3f}'} s "
        f"(heartbeat_timeout_s {hb_timeout:.3f})")
    check("unpaired" not in pairing.values(), f"every fault paired: {pairing}")
    check(all(pairing[f.key] == "recovered" for f in plan), f"every fault recovered: {pairing}")
    # Every restart asks the scheduler (the crashed and the hung silo's
    # too); the revoked silo's is the one the plan names.
    moved = [e for e in replaced if e.task == cids[3]]
    check(len(moved) == 1 and moved[0].old_vm == placement0[cids[3]].vm_id
          and moved[0].new_vm != moved[0].old_vm
          and placement[cids[3]].vm_id == moved[0].new_vm
          and all(e.new_vm != e.old_vm for e in replaced)
          and {e.task for e in replaced} == {cids[1], cids[3], cids[4]},
          f"the revoked silo lands on another VM: {replaced}")
    check(driver.cohort == cids, f"every silo still in the cohort: {driver.cohort}")

    # Folded weight, launches, wire bytes.
    samples = sum(s.n_train for s in silos)
    weights = {}
    for e in trace:
        if type(e).__name__ == "UpdateFolded":
            weights[e.round_idx] = weights.get(e.round_idx, 0.0) + e.weight
    n_folded = sum(1 for e in trace if type(e).__name__ == "UpdateFolded")
    say(f"[live] folded weight per round {weights} (the silos' samples: {samples}); "
        f"{n_folded} folded updates; launches in this process {_nonzero(launches)}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    check(weights == {r: float(samples) for r in range(1, LIVE_ROUNDS + 1)},
          f"every round folds all {n_silos} silos' samples: {weights}")
    check(launches == dict.fromkeys(KERNELS, 0) | {"dequant_fold": n_folded}
          and n_folded == n_silos * LIVE_ROUNDS,
          f"dequant_fold once per folded update, nothing else: {launches}, {n_folded} folds")
    want_bytes = compressed_wire_bytes(PAPER_L, parse_compression("int8"))
    replies = [m["payload"] for m in rec.received if m["kind"] == "c_msg_train"]
    odd = [n for n in replies if n != want_bytes]
    say(f"[live] {len(replies)} c_msg_train replies, {len(replies) - len(odd)} of "
        f"compressed_wire_bytes(L, int8) = {want_bytes} B, others {odd} (the corrupt frame "
        f"is cut to half)")
    check(odd == [want_bytes // 2] and len(replies) == n_folded + 1,
          "every reply is compressed_wire_bytes(L, int8) but the one corrupt frame")

    # Eq. 6 fed from the measured log.
    log1 = res.rounds[0].message_log
    measured = dataclasses.asdict(to_cost_model_sizes(log1))
    say(f"[live] cost model message sizes after round 1: {snap['messages']}; the measured "
        f"log gives {measured}; femnist_application() estimated {estimate}")
    check(snap["messages"] == measured, "the cost model carries round 1's measured sizes")

    say(f"[live] traced round 1: wall {snap['trace_wall_s']:.3f} s, device busy "
        f"{busy_s:.3f} s ({n_kernels} kernels), idle share "
        f"{1 - busy_s / snap['trace_wall_s']:.1%}; most device time: "
        + "; ".join(f"{n[:50]} {t:.1f} ms" for n, t in top))

    # Round 1 replayed in process on its recorded arrivals.
    arrivals = {e.client_id: ClientArrival(e.client_id, e.arrival_s)
                for e in driver.fold_reports[0].events}
    live_r1 = []
    for e in trace:
        live_r1.append(e)
        if type(e).__name__ == "RoundClosed":
            break
    replay_clients = _femnist_clients(cfg, _femnist_live_silos(), make_optimizer("adamw", 1e-4),
                                      "cuda")
    server = AsyncFLServer(
        replay_clients,
        init_femnist_cnn(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda"),
        schedule=RecordedSchedule(arrivals), compression="int8", device="cuda")
    replay = server.run(1)
    diff = max((x.float() - y.float()).abs().max().item() for x, y in
               zip(tree_leaves(replay.final_params), tree_leaves(snap["params"])))
    same_sig = chaos_signature(server.bus.trace) == chaos_signature(live_r1)
    say(f"[live] round 1 replayed in process on its recorded arrivals: max|param live - "
        f"replay| = {diff:.3e} (tol 2e-5); chaos_signature equal: {same_sig}")
    check(diff <= 2e-5, "the replayed round agrees with the live round within 2e-5")
    check(same_sig, "the replayed round's chaos_signature equals the live round's")
    check(all(t.is_cuda for t in tree_leaves(res.final_params)), "every parameter on cuda")
    check(all(math.isfinite(r.metrics["loss"]) for r in res.rounds), "finite losses")
    torch.backends.cudnn.deterministic = False
    out = {"launches": launches, "rounds": rows, "wall_s": wall, "pairing":
           {"/".join(map(str, k)): v for k, v in pairing.items()},
           "replaced": [dataclasses.asdict(e) for e in replaced],
           "crash_to_rearrival_s": crash_to_rearrival, "hang_to_detection_s": hang_to_detection,
           "heartbeat": {"serialize_s": ser_s, "serialize_gil_hold_s": ser_gap,
                         "deserialize_s": de_s, "deserialize_gil_hold_s": de_gap,
                         "frame_loopback_s": send_s, "frame_gil_hold_s": send_gap,
                         "training_gil_hold_s": train_gap, "dispatch_s": dispatch_s, "timeout_s": hb_timeout,
                         "interval_s": hb_interval},
           "folded_weight": weights, "c_msg_train_bytes": want_bytes,
           "cost_model_after_round_1": snap["messages"], "estimate": estimate,
           "trace": {"wall_s": snap["trace_wall_s"], "device_busy_s": busy_s,
                     "n_kernels": n_kernels, "top_ms": top},
           "replay_max_param_diff": diff, "replay_signature_equal": same_sig,
           "losses": [r.metrics["loss"] for r in res.rounds], "peak_bytes": peak}
    del driver, res, clients, wrapped, server, replay, snap, params0
    torch.cuda.empty_cache()
    return out


def _ssm_live_client(index: int):
    """Spawned-worker factory: the ``index``-th mamba2-130m silo of
    ``_zoo_fedavg_phase``, built in the child on the card.  Its ``train``
    raises (a crash the driver sees as EOF) unless the weights it received
    are CUDA tensors and the child's own ``ssd_chunk_scan`` and
    ``ssd_intra_chunk_bwd`` launched during the call."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_silos
    from repro_torch.federated import FLClient
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan, ssd_intra_chunk_bwd
    from repro_torch.launch.steps import make_optimizer_for
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("mamba2-130m")
    model = get_model(cfg)
    silo = make_lm_silos(ZOO_SILOS, cfg.vocab_size, PREFILL_S, [(4, 2)] * ZOO_SILOS, seed=0)[index]

    def loss_fn(p, b):
        return model.loss(p, {"tokens": b[0], "labels": b[1]})

    class KernelCheckedClient(FLClient):
        def train(self, global_params):
            if not all(t.is_cuda for t in tree_leaves(global_params)):
                raise RuntimeError("the silo's weights are not on the card")
            fwd, bwd = ssd_chunk_scan.launches, ssd_intra_chunk_bwd.launches
            res = super().train(global_params)
            if ssd_chunk_scan.launches == fwd or ssd_intra_chunk_bwd.launches == bwd:
                raise RuntimeError("the silo trained without the SSD kernels")
            return res

    return KernelCheckedClient(silo.client_id, silo, loss_fn, make_optimizer_for(cfg),
                               batch_size=2, device="cuda")


def phase_live_process_round():
    """mamba2-130m silos as spawned processes on the card: ZOO_SILOS
    ``ProcessWorkerPool`` children (``_ssm_live_client``), each building
    its client and the template on the card, int8 updates, 2 rounds; in
    round 1 the second silo's VM is revoked during evaluation, so its
    process is terminated and a replacement spawned on the same card,
    which trains round 2.  No RevocationOccurred and no exclusion may
    appear: each child's ``train`` raises unless both SSD kernels ran in
    it on CUDA weights.  Each fold is held against the plain weighted fold
    of the same decoded deltas, in the same order, on the card."""
    import functools

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.events import RoundDispatched
    from repro_torch.federated import (
        FaultPlan, FaultSpec, LiveRoundDriver, ProcessWorkerPool, agg_engine, compression,
        transport)
    from repro_torch.kernels.dequant_fold import dequant_fold_plain, f32_scalar
    from repro_torch.models import get_model
    from repro_torch.utils.tree import tree_flatten

    cfg = get_config("mamba2-130m")
    model = get_model(cfg)
    params0 = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = model.param_count(params0)
    cids = [f"client_{i}" for i in range(ZOO_SILOS)]

    class TimedPool(ProcessWorkerPool):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.spawned_at = {}

        def _spawn(self, client_id, address):
            self.spawned_at.setdefault(client_id, []).append(time.monotonic())
            super()._spawn(client_id, address)

    pool = TimedPool({cid: functools.partial(_ssm_live_client, i) for i, cid in enumerate(cids)},
                     params0, compression="int8", device="cuda")
    plan = FaultPlan([FaultSpec("revocation", cids[-1], 1, phase="eval")])
    rec = _recording_transport()
    driver = LiveRoundDriver(pool, params0, transport=rec, compression="int8", device="cuda",
                             reply_timeout_s=LIVE_REPLY_TIMEOUT_S, startup_timeout_s=300.0,
                             max_rerequests=0, chaos=plan)
    fold_checks = []
    engine_fold = driver._engine.fold_round

    def checked_fold(round_idx, results, schedule, deadline=None, base_params=None,
                     emit_partial=False):
        report = engine_fold(round_idx, results, schedule, deadline=deadline,
                             base_params=base_params, emit_partial=emit_partial)
        plan_ = agg_engine.plan_for(base_params)
        base_flat = plan_.flatten(base_params)
        lp = -(-plan_.total_elems // compression.QBLOCK) * compression.QBLOCK
        acc = torch.zeros(lp, dtype=torch.float32, device="cuda")
        by_id = {r.client_id: r for r in results}
        wsum = 0.0
        for ev in report.events:
            u = by_id[ev.client_id].params
            dequant_fold_plain(acc, u.data.to("cuda"), u.scales.to("cuda"), ev.folded_weight)
            wsum += ev.folded_weight
        want = plan_.unflatten(base_flat + acc[:plan_.total_elems] * f32_scalar(1.0 / wsum))
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(tree_flatten(report.params)[0], tree_flatten(want)[0]))
        fold_checks.append({"round": round_idx, "max_abs_err": err,
                            "order": [ev.client_id for ev in report.events],
                            "weights": [ev.folded_weight for ev in report.events]})
        del base_flat, acc, want
        return report

    driver._engine.fold_round = checked_fold
    round_t0 = {}
    driver.bus.subscribe(RoundDispatched,
                         lambda ev: round_t0.__setitem__(ev.round_idx, time.monotonic()))
    spans = _Spans()
    spans.wrap(transport, "serialize_pytree", "serialize_pytree")
    folds, undo_folds = _fold_device_timer()
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.monotonic()
    try:
        with driver:
            res = driver.run(LIVE_PROC_ROUNDS)
    finally:
        spans.restore()
        undo_folds()
    wall = time.monotonic() - t0
    launches = counts()
    trace = driver.trace
    rows = _round_splits(rec, spans, folds, round_t0, res.rounds)
    _say_splits("[live-proc]", rows)
    hello = {cid: [j - s for s, j in zip(pool.spawned_at.get(cid, []), rec.joined.get(cid, []))]
             for cid in cids}
    revoked = [e for e in trace if type(e).__name__ == "RevocationOccurred"]
    excluded = [r.excluded for r in driver.fold_reports]
    n_folded = sum(1 for e in trace if type(e).__name__ == "UpdateFolded")
    say(f"[live-proc] mamba2-130m bf16, {n_params:,} parameters, {ZOO_SILOS} spawned silos, "
        f"{LIVE_PROC_ROUNDS} int8 rounds in {wall:.1f} s; spawn to hello (s) "
        + ", ".join(f"{cid} " + "/".join(f"{x:.2f}" for x in xs) for cid, xs in hello.items())
        + f"; revocations {len(revoked)}, exclusions {excluded}; launches in this process "
        f"{_nonzero(launches)}; folds against the plain fold: "
        + ", ".join(f"round {c['round']} {c['order']} max|diff| {c['max_abs_err']:.3e}"
                    for c in fold_checks))
    check(not revoked and not any(excluded),
          "no revocation and no exclusion: every child trained on CUDA weights through "
          "ssd_chunk_scan and ssd_intra_chunk_bwd")
    check(len(pool.spawned_at[cids[-1]]) == 2 and len(rec.joined.get(cids[-1], [])) == 2,
          "the eval-phase revocation terminated the process and its replacement rejoined")
    check(driver.cohort == cids, "both silos still in the cohort")
    check(n_folded == ZOO_SILOS * LIVE_PROC_ROUNDS
          and launches == dict.fromkeys(KERNELS, 0) | {"dequant_fold": n_folded},
          f"dequant_fold once per folded update in this process, nothing else: {launches}")
    check(len(fold_checks) == LIVE_PROC_ROUNDS
          and all(c["max_abs_err"] <= 2e-5 for c in fold_checks),
          "each fold equals the plain weighted fold of the decoded deltas within 2e-5")
    check(all(math.isfinite(r.metrics["loss"]) for r in res.rounds), "finite losses")
    out = {"launches": launches, "rounds": rows, "wall_s": wall, "spawn_to_hello_s": hello,
           "fold_checks": fold_checks, "n_params": n_params,
           "losses": [r.metrics["loss"] for r in res.rounds]}
    del driver, res, params0, pool
    torch.cuda.empty_cache()
    return out


def _toy_live_clients(device: str):
    """tests/test_chaos.py's three paced silos (12, 20, 16 examples of a
    3-weight linear model; replies 0, 0.05, 0.1 s apart), warmed up."""
    import numpy as np
    import torch
    from repro_torch.federated import FLClient
    from repro_torch.optim import make_optimizer

    class Silo:
        def __init__(self, client_id, x, y):
            self.client_id, self.x, self.y = client_id, x, y

        def batches(self, batch_size, split="train"):
            for i in range(0, len(self.x), batch_size):
                yield (self.x[i:i + batch_size], self.y[i:i + batch_size])

    class Paced(FLClient):
        def train(self, global_params):
            time.sleep(self.delay_s)
            return super().train(global_params)

    def loss(p, b):
        return torch.mean((b[0] @ p["w"] - b[1]) ** 2)

    rng = np.random.default_rng(0)
    out = []
    for cid, n, delay in (("c0", 12, 0.0), ("c1", 20, 0.05), ("c2", 16, 0.1)):
        x = rng.standard_normal((n, 3)).astype(np.float32)
        y = rng.standard_normal((n,)).astype(np.float32)
        c = Paced(cid, Silo(cid, x, y), loss, make_optimizer("sgdm", 1e-2), batch_size=8,
                  device=device)
        c.delay_s = 0.0
        c.train({"w": torch.zeros(3, device=device)})
        c.evaluate({"w": torch.zeros(3, device=device)})
        c.delay_s = delay
        out.append(c)
    return out


def _toy_scheduler():
    """``DynamicScheduler(CostModel(env, app, 0.5))`` over tests/conftest.py's
    toy environment (3 VMs, two providers) and application (3 clients)."""
    from repro_torch.core import (
        ClientSpec, CloudEnvironment, CostModel, DynamicScheduler, FLApplication,
        MessageSizes, Provider, Region, VMType)

    regions = ["r0", "r1", "r0"]
    env = CloudEnvironment(
        [Provider("p0", 0.01), Provider("p1", 0.02)], [Region("r0", "p0"), Region("r1", "p1")],
        [VMType(f"vm{i}", f"t{i}", "p0" if r == "r0" else "p1", r, 4, 0, 16, 1.0 + i,
                (1.0 + i) * 0.3) for i, r in enumerate(regions)])
    env.sl_inst = {f"vm{i}": 1.0 for i in range(3)}
    env.sl_comm = {("r0", "r0"): 1.0, ("r0", "r1"): 2.0, ("r1", "r1"): 1.0}
    app = FLApplication(name="toy", clients=[ClientSpec(f"c{i}", 100.0, 10.0) for i in range(3)],
                        messages=MessageSizes(0.1, 0.1, 0.1, 1e-6), n_rounds=5,
                        train_comm_bl=5.0, test_comm_bl=1.0, aggreg_bl=1.0)
    return DynamicScheduler(CostModel(env, app, 0.5))


def phase_chaos_soak(ckpt_root: Path):
    """tests/test_chaos.py's soak at its own toy size, tensors on the card:
    one plan over five rounds (crash, slow, corrupt frame, hang, a §4.4
    cross-host revocation, checkpoint sabotage with server and client
    checkpoints), replayed on the live driver (threads, loopback,
    heartbeats every 0.2 s with a 2 s bound) and on the virtual-clock
    ``AsyncFLServer``.  A check of semantics, small by design."""
    import torch
    from repro_torch.checkpoint import ClientCheckpointManager, ServerCheckpointManager
    from repro_torch.core import Assignment
    from repro_torch.core.events import EventBus
    from repro_torch.federated import (
        AsyncFLServer, ChaosSchedule, DeterministicSchedule, FaultPlan, FaultSpec,
        LiveRoundDriver, ThreadWorkerPool, chaos_signature, checkpoint_saboteur,
        verify_fault_pairing)

    plan = FaultPlan([
        FaultSpec("crash", "c0", 1), FaultSpec("slow", "c1", 2, delay_s=0.25),
        FaultSpec("corrupt_frame", "c2", 2), FaultSpec("hang", "c1", 3, delay_s=0.25),
        FaultSpec("revocation", "c0", 4), FaultSpec("corrupt_checkpoint", "s", 4),
    ], seed=7)

    def ckpts(root):
        server = ServerCheckpointManager(str(root / "server_local"), str(root / "server_remote"),
                                         interval_rounds=1, keep_last=3)
        return server, {c: ClientCheckpointManager(str(root / f"ckpt_{c}"))
                        for c in ("c0", "c1", "c2")}

    def init():
        return {"w": torch.zeros(3, device="cuda")}

    live_server, live_clients = ckpts(ckpt_root / "live")
    placement = {cid: Assignment("vm0", "spot") for cid in ("s", "c0", "c1", "c2")}
    driver = LiveRoundDriver(
        ThreadWorkerPool(plan.wrap_clients(_toy_live_clients("cuda")), init(), device="cuda"),
        init(), device="cuda", chaos=plan, reply_timeout_s=60.0, max_rerequests=2, scheduler=_toy_scheduler(),
        placement=placement, server_ckpt=live_server, client_ckpts=live_clients, **SOAK_HB)
    t0 = time.monotonic()
    with driver:
        live = driver.run(5)
    wall = time.monotonic() - t0
    sim_server, sim_clients = ckpts(ckpt_root / "sim")
    bus = EventBus()
    server = AsyncFLServer(
        _toy_live_clients("cuda"), init(),
        schedule=ChaosSchedule(DeterministicSchedule({"c0": 0.01, "c1": 0.02, "c2": 0.03}),
                               plan, bus=bus),
        on_revocation="rerequest", max_rerequests=2, bus=bus, server_ckpt=sim_server,
        client_ckpts=sim_clients, fault_hook=checkpoint_saboteur(plan, sim_server, bus),
        device="cuda")
    sim = server.run(5)
    pairings = [verify_fault_pairing(plan, t) for t in (driver.trace, server.bus.trace)]
    weights = []
    for t in (driver.trace, server.bus.trace):
        w = {}
        for e in t:
            if type(e).__name__ == "UpdateFolded":
                w[e.round_idx] = w.get(e.round_idx, 0.0) + e.weight
        weights.append(w)
    same_sig = chaos_signature(driver.trace) == chaos_signature(server.bus.trace)
    recoveries = [(e.resume_round, e.restored_from) for e in driver.trace
                  if type(e).__name__ == "RecoveryCompleted"]
    replaced = [(e.task, e.old_vm, e.new_vm) for e in driver.trace
                if type(e).__name__ == "VMReplaced"]
    diff = (live.final_params["w"] - sim.final_params["w"]).abs().max().item()
    say(f"[soak] 5 rounds on the card in {wall:.1f} s: live pairing "
        + ", ".join(f"{k[0]} {k[1]} r{k[2]}: {v}" for k, v in pairings[0].items())
        + f"; folded weight live {weights[0]}, virtual {weights[1]}; chaos_signature equal: "
        f"{same_sig}; recoveries {recoveries}; VM replacements {replaced}; max|param live - "
        f"virtual| {diff:.3e}")
    check(all("unpaired" not in p.values() for p in pairings), "every fault paired on both")
    check(all(w == {r: 48.0 for r in range(1, 6)} for w in weights), "folded weight conserved")
    check(same_sig, "live and virtual-clock chaos signatures equal")
    check(len(recoveries) == 1 and recoveries[0][0] == 4 and recoveries[0][1] != "none",
          "round 4 resumed from a verified checkpoint")
    check(replaced and all(old != new for _, old, new in replaced), "revoked silos moved")
    check(diff <= 1e-5 and live.final_params["w"].is_cuda, "the two drivers' params close")
    check(driver.cohort == ["c0", "c1", "c2"], "every silo still in the cohort")
    return {"wall_s": wall, "pairing": {"/".join(map(str, k)): v
                                        for k, v in pairings[0].items()},
            "signature_equal": same_sig, "recoveries": recoveries, "replaced": replaced,
            "max_param_diff": diff}


PHASE_S: dict = {}   # seconds each phase of main() took, in order


def timed(phase, *args):
    """``phase(*args)``, its wall time printed and kept in PHASE_S; then the
    phase's cyclic garbage collected, and the card memory still allocated
    printed (what later phases, the pod round's ~69.5 GiB among them, do
    not get)."""
    import torch

    t0 = time.monotonic()
    out = phase(*args)
    PHASE_S[phase.__name__] = time.monotonic() - t0
    gc.collect()
    say(f"[phase] {phase.__name__} {PHASE_S[phase.__name__]:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated)")
    return out


def main() -> int:
    import torch
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce  # noqa: F401 (fail early)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.monotonic()
    smi = timed(phase_device)
    sass, ptxas = timed(phase_build)
    main_err = timed(phase_kernel_check)
    dq_err = timed(phase_dequant_check)
    flash_err = timed(phase_flash_check)
    bwd_err = timed(phase_flash_bwd_check)
    ssd_err = timed(phase_ssd_check)
    ssd_bwd_err = timed(phase_ssd_bwd_check)
    timing = timed(phase_kernel_timing)
    dq_timing = timed(phase_dequant_timing)
    zoo_timing = timed(phase_zoo_timing)
    ssd_bwd_timing = timed(phase_ssd_bwd_timing)   # before any phase that traces
    shape_timing = timed(phase_flash_shape_timing)
    bwd_timing = timed(phase_flash_bwd_timing)
    fold = timed(phase_fold_breakdown)
    compressed_split = timed(phase_compressed_breakdown)
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_ckpt_") as d:
        path = timed(phase_main_path, Path(d))
    compressed = timed(phase_compressed_path)
    reference = timed(phase_reference_check)
    compressed_reference = timed(phase_compressed_reference_check)
    zoo = timed(phase_zoo_paths)
    moe_zoo = timed(phase_moe_paths)
    encdec_zoo = timed(phase_encdec_paths)
    hybrid_zoo = timed(phase_hybrid_paths)
    zoo_reference = timed(phase_zoo_reference_check)
    train_step = timed(phase_train_step)
    trainer = timed(phase_trainer_entry)
    lora = timed(phase_lora_rounds)
    ssm_train = timed(phase_ssm_train_step)
    ssm_fedavg = timed(phase_ssm_fedavg_rounds)
    moe_train = timed(phase_moe_train_step)
    moe_fedavg = timed(phase_moe_fedavg_rounds)
    encdec_train = timed(phase_encdec_train_step)
    hybrid_train = timed(phase_hybrid_train_step)
    train_reference = timed(phase_train_reference_check)
    # The hierarchy's NCCL pods are destroyed before the live phases spawn.
    hier_exact = timed(phase_hierarchy_exactness)
    hier_round = timed(phase_hierarchy_round)
    hier_lora = timed(phase_hierarchy_lora)
    stacked = timed(phase_stacked_reduce)
    pod_mesh = timed(phase_pod_mesh)   # its NCCL group is destroyed before the live phases
    pod = timed(phase_pod_round)
    pod_olmo, pod_ssm = pod["olmo-1b"]["launches"], pod["mamba2-130m"]["launches"]
    live = timed(phase_live_round)
    live_proc = timed(phase_live_process_round)
    with tempfile.TemporaryDirectory(dir=build_root, prefix="chip_smoke_soak_") as d:
        soak = timed(phase_chaos_soak, Path(d))

    dq = dq_timing["int8"]
    kernels = [{
        "name": "fedavg_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:27",
        # The barrier path's rounds, the stacked reduce and each model's pod round.
        "launches": (path["launches"] + stacked["launches"]["fedavg_reduce"]
                     + pod_olmo["fedavg_reduce"] + pod_ssm["fedavg_reduce"]),
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
        # The compressed path's int8 run, the hierarchy's routes and rounds,
        # and both live phases' folds.
        "launches": (compressed["int8"]["launches"]["dequant_fold"]
                     + hier_exact["launches"]["dequant_fold"]
                     + hier_round["launches"]["dequant_fold"]
                     + hier_round["cohort_launches"]["dequant_fold"]
                     + hier_lora["launches"]["dequant_fold"]
                     + live["launches"]["dequant_fold"] + live_proc["launches"]["dequant_fold"]),
        "max_abs_err": dq_err,
        "ms": dq["ms"],
        "plain_ms": dq["plain_ms"],
        "bound_ms": dq["bound_ms"],
        "bound_by": dq["bound_by"],
        "library_ms": dq["library_ms"],
    }]
    # A kernel's launches: summed over the full-width runs that go through
    # it, one run a path (a prefill a served model, a step a trained one).
    for name, src, replaces, launches, err in (
            ("flash_attention", "flash_attention.cu", "flash_attention.py:30",
             sum(zoo_run["prefill_launches"]["flash_attention"]
                 for zoo_run in (zoo["olmo-1b bf16"], moe_zoo["granite-moe-1b-a400m bf16"],
                                 moe_zoo["deepseek-moe-16b bf16"],
                                 encdec_zoo["whisper-small bf16"],
                                 hybrid_zoo[f"{JAMBA} bf16"]))
             + pod_olmo["flash_attention"], flash_err),
            ("ssd_chunk_scan", "ssd_scan.cu", "ssd_scan.py:27",
             sum(zoo_run["prefill_launches"]["ssd_chunk_scan"]
                 for zoo_run in (zoo["mamba2-130m bf16"], hybrid_zoo[f"{JAMBA} bf16"]))
             + pod_ssm["ssd_chunk_scan"], ssd_err)):
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
        "launches": (train_step["launches"]["flash_attention_bwd"]
                     + moe_train["launches"]["flash_attention_bwd"]
                     + encdec_train["launches"]["flash_attention_bwd"]
                     + hybrid_train["launches"]["flash_attention_bwd"]
                     + pod_olmo["flash_attention_bwd"]),
        "max_abs_err": bwd_err,
        "ms": bwd_timing["ms"],
        "plain_ms": bwd_timing["plain_ms"],
        "bound_ms": bwd_timing["bound_ms"],
        "bound_by": bwd_timing["bound_by"],
        "library_ms": bwd_timing["library_ms"],
    })
    kernels.append({
        "name": "ssd_intra_chunk_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/mamba2.py:63",
        "launches": (ssm_train["launches"]["ssd_intra_chunk_bwd"]
                     + hybrid_train["launches"]["ssd_intra_chunk_bwd"]
                     + pod_ssm["ssd_intra_chunk_bwd"]),
        "max_abs_err": ssd_bwd_err,
        "ms": ssd_bwd_timing["ms"],
        "plain_ms": ssd_bwd_timing["plain_ms"],
        "bound_ms": ssd_bwd_timing["bound_ms"],
        "bound_by": ssd_bwd_timing["bound_by"],
        "library_ms": ssd_bwd_timing["library_ms"],
    })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "nvidia_smi": smi, "sass_counts": sass, "ptxas": ptxas, "kernels": kernels, "timing": timing, "fold": fold, "path": path,
        "reference": reference, "dequant_timing": dq_timing,
        "compressed_breakdown": compressed_split, "compressed_path": compressed,
        "compressed_reference": compressed_reference, "zoo_timing": zoo_timing, "zoo": zoo,
        "zoo_reference": zoo_reference, "flash_bwd_timing": bwd_timing,
        "flash_shape_timing": shape_timing, "moe_zoo": moe_zoo, "moe_train": moe_train,
        "moe_fedavg": moe_fedavg,
        "encdec_zoo": encdec_zoo, "encdec_train": encdec_train,
        "hybrid_zoo": hybrid_zoo, "hybrid_train": hybrid_train,
        "train_step": train_step, "trainer": trainer, "lora": lora,
        "ssd_bwd_timing": ssd_bwd_timing, "ssm_train": ssm_train, "ssm_fedavg": ssm_fedavg,
        "train_reference": train_reference, "hierarchy_exactness": hier_exact,
        "hierarchy_round": hier_round, "hierarchy_lora": hier_lora, "stacked_reduce": stacked,
        "pod_mesh": pod_mesh, "pod_round": pod,
        "live": live, "live_proc": live_proc,
        "soak": soak, "phase_s": PHASE_S,
        "seconds": time.monotonic() - t_start,
    }, indent=1))
    say(f"[done] {time.monotonic() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
