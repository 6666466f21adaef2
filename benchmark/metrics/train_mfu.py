"""The window's share of the peak of the configuration's precision (67
TFLOP/s float32, 989 bfloat16): the FLOPs of forward and backward that
its steps need (from the counters, GP and PL on their steps, no
recomputation) over the window's wall time."""


def read(rec):
    if rec["kind"] != "train" or not rec.get("window_flops") or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["window_flops"] / rec["window_s"] / rec["peak_flops"]
