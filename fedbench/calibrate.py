#!/usr/bin/env python3
"""The readings a cell's check limits are set from (not run by the
benchmark's own runs):

    python3 fedbench/calibrate.py --workload <name> --seeds 1 2 ... --control-seeds 7 8 9

For each of ``--seeds``: set-up's rounds of the system against the plain
reference (the sound runs: the lower readings), and the fold stage's
control and fault on what the program's silos shipped in those rounds:
the reference's fold with the codec's bits halved (int4 for int8) or,
for a dense update, with the shipped weights rounded one precision below
the configuration's; and, with a codec, the fold of silos that forget
what their codec dropped (``no_feedback``).  ``--fold-only`` takes only
these ``fold`` readings.  For each of ``--control-seeds``: the reference
against itself computed one precision below the configuration's (the
control: TF32 for float32, E4M3 for bfloat16), and against itself with
each planted fault (``half_batch``, ``answer``).  One JSON line a reading
on standard output, then the largest sound and the smallest control and
fault reading of each number.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
FAULTS = ("half_batch", "answer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--kinds", nargs="*", default=None,
                    help="the control and fault readings to take (default: all)")
    ap.add_argument("--fold-only", action="store_true",
                    help="take only the fold stage's readings on --seeds")
    args = ap.parse_args(argv)

    import torch

    from fedbench import harness
    from fedbench.check import fold_gap, readings
    from fedbench.reference.fedavg import fold_rounds

    device = torch.device("cuda")
    spec = harness.cell_spec(args.workload)
    kinds: dict = {}

    def emit(kind: str, seed: int, numbers: dict) -> None:
        kinds.setdefault(kind, []).append(numbers)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(json.dumps({"kind": kind, "seed": seed, **numbers, "peak_gib": peak,
                          "at_s": time.monotonic() - T0}), flush=True)

    update = spec["traffic"]["update"]
    ctl = CONTROL[spec["config"]["compute_dtype"]]
    fold_kinds = ({"control:int4": {"bits": 4}, "fault:no_feedback": {"error_feedback": False}}
                  if update != "dense" else {f"control:{ctl}": {"precision": ctl}})
    for seed in args.seeds:
        first = harness.first_round(spec, seed, device)
        prog, silos, rounds = first["prog"], first["silos"], first["fold"]
        del first
        harness.free(device)
        print(f"seed {seed}: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated "
              "after the program was freed", file=sys.stderr, flush=True)
        want = fold_rounds(rounds, update)
        fold = fold_gap(rounds, want)
        for kind, kw in fold_kinds.items():
            got = [dict(r, new=x) for r, x in zip(rounds, fold_rounds(rounds, update, **kw))]
            emit(kind, seed, {"fold": fold_gap(got, want)})
        if args.fold_only:
            emit("sound", seed, {"fold": fold})
            continue
        ref = harness.reference_round(spec, silos, seed, device)
        emit("sound", seed, readings(prog, ref, harness.evaluated(spec, prog["params1"], silos,
                                                                    device), fold))
        del prog, ref
        harness.free(device)
    fam = harness.load_module("families", spec["config"]["family"])
    for seed in args.control_seeds:
        silos = fam.make_silos(spec["config"], spec["traffic"], seed, device)
        ref = harness.reference_round(spec, silos, seed, device)
        ref.pop("params1")
        for kind, kw in [(f"control:{ctl}", {"precision": ctl})] + [
                (f"fault:{f}", {"fault": f}) for f in FAULTS]:
            if args.kinds is not None and kind not in args.kinds:
                continue
            got = harness.reference_round(spec, silos, seed, device, **kw)
            numbers = readings(got, ref, harness.evaluated(spec, got.pop("params1"), silos, device))
            numbers.pop("fold")   # the fold's control and fault are taken on --seeds
            emit(kind, seed, numbers)
            del got
            harness.free(device)
    summary = {}
    for kind, rows in kinds.items():
        pick = max if kind == "sound" else min
        got = [(k, v) for r in rows for k, v in r.items()]
        summary[kind] = {k: pick(v for kk, v in got if kk == k) for k in dict(got)}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "seconds": time.monotonic() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
