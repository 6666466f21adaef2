"""The share of the traced extraction call in which no device event ran."""


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "attfind" or not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
