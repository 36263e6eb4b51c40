"""The SSD scan's share of its roofline in the traced rounds: the least
time the rounds' intra-chunk SSD work must take
(``fedbench/work/ssd_chunk_scan.py`` a forward, ``ssd_scan_bwd.py`` a
backward, each the larger of its operations at its rate's peak and its
bytes at the HBM bandwidth; a train call a forward and a backward, an
evaluation call a forward) over the device time of the kernels whose
names carry ``SYMBOLS``.  The work is counted from the cell's shapes,
whatever runs it; a kernel under another name leaves the metric
silent."""

from fedbench.harness import load_module

SYMBOLS = ("ssd_intra", "bwd_heads", "bwd_dA", "bwd_chunk")


def _least(w, peaks):
    return max(w["flops"] / peaks["flops_per_s"][w["rate"]], w["bytes"] / peaks["hbm_bytes_per_s"])


def read(rec):
    t = rec["trace"]
    ssd = rec["work"].get("ssd")
    if t is None or ssd is None or rec["device"] != "cuda":
        return None
    device_s = sum(s for name, s in t["device_ops"].items() if any(k in name for k in SYMBOLS))
    if device_s <= 0:
        return None
    peaks, shape = rec["peaks"], ssd["shape"]
    fwd = _least(load_module("work", "ssd_chunk_scan").work(**shape), peaks)
    bwd = _least(load_module("work", "ssd_scan_bwd").work(**shape), peaks)
    least = ssd["train_calls"] * (fwd + bwd) + ssd["eval_calls"] * fwd
    return 100.0 * least * len(t["rounds"]) / device_s
