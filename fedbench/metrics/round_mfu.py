"""The model FLOPs of the window's untraced rounds (``fedbench/flops/``)
over their host time at the peak rate of the configuration's compute
dtype (``fedbench/peaks.json``), in percent."""


def read(rec):
    if rec["device"] != "cuda":
        return None
    peak = rec["peaks"]["flops_per_s"][rec["config"]["compute_dtype"]]
    return 100.0 * rec["flops"] * len(rec["rounds"]) / (rec["window_s"] * peak)
