"""Attention's share of its roofline in the traced rounds: the least time
the rounds' attention must take (``fedbench/work/flash_attention.py`` a
forward, ``flash_attention_bwd.py`` a backward, each the larger of its
operations at the bfloat16 peak and its bytes at the HBM bandwidth) over
the device time of the kernels whose names carry ``SYMBOLS``.  A kernel
under another name leaves the metric silent."""

from fedbench.harness import load_module

SYMBOLS = ("flash_fwd", "bwd_dq", "bwd_dkdv", "bwd_delta")


def _least(w, peaks):
    return max(w["flops"] / peaks["flops_per_s"]["bfloat16"], w["bytes"] / peaks["hbm_bytes_per_s"])


def read(rec):
    t = rec["trace"]
    attn = rec["work"].get("attention")
    if t is None or attn is None or rec["device"] != "cuda":
        return None
    device_s = sum(s for name, s in t["device_ops"].items() if any(k in name for k in SYMBOLS))
    if device_s <= 0:
        return None
    peaks, shape = rec["peaks"], attn["shape"]
    fwd = _least(load_module("work", "flash_attention").work(**shape), peaks)
    bwd = _least(load_module("work", "flash_attention_bwd").work(**shape), peaks)
    least = attn["train_calls"] * (fwd + bwd) + attn["eval_calls"] * fwd
    return 100.0 * least * len(t["rounds"]) / device_s
