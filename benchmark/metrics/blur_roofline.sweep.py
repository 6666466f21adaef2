"""The blur kernel's share of its bytes bound in the traced extraction
call: the bytes its calls need (each input element read once, each output
element written once, from the counters) over 3.35 TB/s, over the device
time of the events named ``blur3_kernel``."""

from benchmark import common


def read(rec):
    trace, counts = rec.get("trace"), rec.get("counts")
    if rec["kind"] != "attfind" or not trace or not counts:
        return None
    t = trace["own_kernel_s"]["blur3"]
    if t <= 0:
        return None
    return 100.0 * counts["bytes"]["blur"] / common.PEAK_BYTES_PER_S / t
