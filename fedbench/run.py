#!/usr/bin/env python3
"""One run of one benchmark cell on the card:

    python3 fedbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  It makes the
cell's weights and silo data on the card from ``--seed``, builds or loads
the system's kernels (``build/repro_torch_kernels/``), runs one warm-up
round (two where the update carries a codec), then whole rounds for
``--seconds``; with ``--trace 1`` it then runs the traffic's
``trace_rounds`` under ``torch.profiler`` with the program's spans on.  It checks set-up's rounds
against the plain reference and prints, as its last line,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` (each compared
number with its limit, also the last lines on standard error).

Without a CUDA card, or with fewer cards than the cell asks for, it
exits 2 and prints no result; it exits 3 if JAX or the JAX package was
loaded.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache at a fixed path inside the checkout: only a checkout's first
# run builds.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from fedbench import harness

    spec = harness.cell_spec(args.workload)
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fedbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the system under test must be in the checkout)

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         spec, T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"fedbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"[fedbench] card: {card()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
