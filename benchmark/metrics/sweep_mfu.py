"""The sweep's share of the float32 peak (67 TFLOP/s, outside the
tensor cores, as TF32 is off): the FLOPs the window's untraced calls
need (from the counters) over their wall time."""


def read(rec):
    counts = rec.get("counts")
    if rec["kind"] != "attfind" or not counts:
        return None
    walls = rec["call_walls"][rec["traced_calls"]:] or rec["call_walls"]
    styles = rec["call_styles"][rec["traced_calls"]:] or rec["call_styles"]
    flops = counts["flops"] * sum(styles) / counts["perturbations"]
    return 100.0 * flops / sum(walls) / rec["peak_flops"]
