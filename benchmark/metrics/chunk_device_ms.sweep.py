"""Device milliseconds per sweep chunk: the busy time (the union of the
device's events) of the traced extraction call over its chunks, phase 1
and the capture included."""


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "attfind" or not trace or trace["busy_s"] <= 0:
        return None
    return 1e3 * trace["busy_s"] / rec["chunks_per_call"]
