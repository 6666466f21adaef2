"""Milliseconds per traced train step that the host waited on the loader's
queue: the program's ``train.data_wait`` spans over its ``train.step``
spans."""

from benchmark import spans


def read(rec):
    snap = spans.snapshot() if rec["kind"] == "train" else None
    if snap is None:
        return None
    steps, waits = spans.named(snap, "train.step"), spans.named(snap, "train.data_wait")
    if not steps or not waits:
        return None
    return sum(spans.ms(s) for s in waits) / len(steps)
