"""Device time from a ``torch.profiler`` trace: per kernel name, by kind,
busy as the union of the device's intervals, and the idle gaps between
them labelled by what the host was doing.

The reduction is a frozen copy of the program's ``profile_sweep``
(``device_summary`` and ``by_kind``): the device's own events (kernels,
copies, memsets) are kept and user annotations dropped, since the operator
events that launch kernels and the annotations on the device's timeline
carry the same time again. The busy time is the union of those events'
intervals, so overlapping streams are not counted twice.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

# the program's hand-written kernels: name -> a substring of their symbols
OWN_KERNELS = {"upsample2x_bilinear": "upsample2x_bilinear_kernel", "blur3": "blur3_kernel"}

# kernel kinds by name, first match wins (cuDNN's layout transposes first)
KINDS = (
    ("hand-written kernels", tuple(OWN_KERNELS.values())),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution and GEMM", ("xmma", "convolve", "cudnn", "gemm", "fft", "wgrad", "dgrad",
                              "conv_depthwise", "cutlass", "pointwise_mult_and_sum_complex")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise, copy, fill", ("elementwise", "copy", "Fill")),
)

Interval = Tuple[float, float, str]


def device_events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host intervals) of a finished profiler, each
    (start_us, end_us, name) sorted by start. The host's are its operators
    or, where only the device's activity was traced, its CUDA runtime
    calls. Read from the profiler's raw events, without building its
    per-event Python objects."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(span)
        elif e.device_type() == DeviceType.CPU:
            host.append(span)
    dev.sort()
    host.sort()
    return dev, host


def per_name(dev: List[Interval]) -> List[dict]:
    """Device time and count per kernel name, largest first."""
    acc: Dict[str, list] = {}
    for start, end, name in dev:
        a = acc.setdefault(name, [0.0, 0])
        a[0] += end - start
        a[1] += 1
    rows = [dict(name=k, us=v[0], calls=v[1]) for k, v in acc.items()]
    rows.sort(key=lambda r: -r["us"])
    return rows


def by_kind(rows: List[dict]) -> Dict[str, float]:
    """Device microseconds summed by kernel kind."""
    out = {kind: 0.0 for kind, _ in KINDS}
    out["other"] = 0.0
    for r in rows:
        kind = next((k for k, keys in KINDS if any(key in r["name"] for key in keys)), "other")
        out[kind] += r["us"]
    return out


def busy_us(dev: List[Interval]) -> float:
    """The union of the device intervals, in microseconds."""
    total, last_end = 0.0, float("-inf")
    for start, end, _ in dev:
        total += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    return total


def idle_gaps(dev: List[Interval], host: List[Interval], lo: float, hi: float,
              top: int = 10) -> List[list]:
    """The device's idle time within [lo, hi] summed by the host event
    that was open when each gap began (the innermost one started last;
    "host between CUDA calls" where none was), the ``top`` largest as
    [label, seconds]."""
    starts = [h[0] for h in host]
    acc: Dict[str, float] = {}
    cursor = lo
    for start, end, _ in dev + [(hi, hi, "")]:
        if start > cursor:
            i = bisect.bisect_right(starts, cursor) - 1
            label = "host between CUDA calls"
            for j in range(i, max(i - 64, -1), -1):  # the nearest enclosing operators
                if host[j][1] >= cursor:
                    label = host[j][2]
                    break
            acc[label] = acc.get(label, 0.0) + (min(start, hi) - cursor) / 1e6
        cursor = max(cursor, end)
    rows = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in rows]


def summarize(prof, window_s: float) -> dict:
    """What the metric readers take from a trace of a window of
    ``window_s`` seconds of wall time."""
    dev, host = device_events(prof)
    rows = per_name(dev)
    kernels = [r for r in rows if not any(k in r["name"] for k in ("Memcpy", "Memset"))]
    out = dict(
        window_s=window_s,
        busy_s=busy_us(dev) / 1e6,
        device_s=sum(r["us"] for r in rows) / 1e6,
        kernel_launches=sum(r["calls"] for r in kernels),
        own_kernel_s={k: sum(r["us"] for r in rows if sym in r["name"]) / 1e6
                      for k, sym in OWN_KERNELS.items()},
        kind_s={k: v / 1e6 for k, v in by_kind(rows).items()},
        device_ops=[[r["name"], r["us"] / 1e6] for r in rows[:10]],
    )
    if dev:
        out["idle_gaps"] = idle_gaps(dev, host, dev[0][0], dev[-1][1])
    return out
