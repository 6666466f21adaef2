"""The host's wall milliseconds per sweep chunk: the mean of the program's
``attfind.chunk`` spans in the traced extraction call. It holds the host's
issue of the chunk's kernels and every implicit synchronisation inside the
chunk (the classifier's copies from pageable memory), so beside
``chunk_device_ms.sweep`` it alone cannot say whether host or device sets
the pace. Read under the profiler, whose tracing slows the host."""

from benchmark import spans


def read(rec):
    snap = spans.snapshot() if rec["kind"] == "attfind" else None
    if snap is None:
        return None
    chunks = spans.named(snap, "attfind.chunk")
    if not chunks:
        return None
    return sum(spans.ms(s) for s in chunks) / len(chunks)
