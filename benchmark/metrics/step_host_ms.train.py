"""The host's wall milliseconds per traced train step: the mean of the
program's ``train.step`` spans, from the step's call to its return. It
holds the host's issue of the step's kernels and every implicit
synchronisation inside the step (copies from pageable memory, ``.item()``),
so it is the issue time only where the step waits on nothing; beside
``step_device_ms.train`` it alone cannot say whether host or device sets the
pace. Read under the profiler, whose tracing slows the host."""

from benchmark import spans


def read(rec):
    snap = spans.snapshot() if rec["kind"] == "train" else None
    if snap is None:
        return None
    steps = spans.named(snap, "train.step")
    if not steps:
        return None
    return sum(spans.ms(s) for s in steps) / len(steps)
