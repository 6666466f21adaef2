"""The share of the traced train steps in which no device event ran."""


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "train" or not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
