"""The fold kernels' share of their roofline in the traced rounds: the
least time the fold must take (``fedbench/work/``: the dense weighted
mean over the silos' float32 rows, or one dequantizing fold a compressed
update) over the device time of the kernels whose names carry
``SYMBOLS``.  The work is counted from the cell's shapes, whatever
kernel does it; a kernel under another name leaves the metric silent."""

from fedbench.harness import load_module

SYMBOLS = ("fedavg_", "dequant_fold")


def read(rec):
    t = rec["trace"]
    if t is None or rec["device"] != "cuda":
        return None
    device_s = sum(s for name, s in t["device_ops"].items() if any(k in name for k in SYMBOLS))
    if device_s <= 0:
        return None
    fold, peaks = rec["work"]["fold"], rec["peaks"]
    if fold["update"] == "dense":
        w = load_module("work", "fedavg_reduce").work(fold["silos"], fold["elems"])
        calls = 1
    else:
        w = load_module("work", "dequant_fold").work(fold["elems"], fold["update"])
        calls = fold["silos"]
    least = calls * max(w["flops"] / peaks["flops_per_s"]["float32"],
                        w["bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * least * len(t["rounds"]) / device_s
