"""The convolutions' share of the float32 peak (67 TFLOP/s, TF32 off) in
the traced extraction call: the call's counted FLOPs (the convolutions and
matrix products of phase 1 and every perturbation, from the counters) over
the device time of the trace's "convolution and GEMM" kernels."""


def read(rec):
    trace, counts = rec.get("trace"), rec.get("counts")
    if rec["kind"] != "attfind" or not trace or not counts:
        return None
    t = trace["kind_s"].get("convolution and GEMM", 0.0)
    if t <= 0:
        return None
    return 100.0 * counts["flops"] / t / rec["peak_flops"]
