"""Device milliseconds per train step: the busy time (the union of the
device's events) of the traced steps over their count."""


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "train" or not trace or not rec["traced_steps"]:
        return None
    return 1e3 * trace["busy_s"] / rec["traced_steps"]
