"""Device kernels launched per train step in the traced steps (copies
and memsets not counted)."""


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "train" or not trace or not rec["traced_steps"]:
        return None
    return trace["kernel_launches"] / rec["traced_steps"]
