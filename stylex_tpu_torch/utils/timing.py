"""Per-call timing of an op on the device, by the slope of a chained loop.

``measure_op`` runs ``fn`` ``n`` times in a loop in which every call
depends on the last: one element of the first floating-point argument (a
private copy of it) takes in one element of the previous call's output
before the next call. So the calls run in order, on distinct inputs, and
the timed region ends only when the last one has. Eager PyTorch runs every
op it is given, so one element carries the chain; the carrier costs one
one-element op per call. The loop is timed at two lengths ``n1 < n2``; the
slope ``(T(n2) - T(n1)) / (n2 - n1)`` cancels what the run costs once, and
the median slope over repeats is the result. On a GPU each length's loop
is captured once as a CUDA graph and replayed between CUDA events on the
current stream: one launch for n calls, as the JAX package's loop is one
executable, so the time is the device's alone, without the host's cost of
issuing each call. On the CPU the loop runs as it is, timed by
``time.perf_counter``.

When the caller gives the bytes the op must move, the implied bandwidth is
held against the card's memory rate (3.35 TB/s, the H100 SXM's HBM, with a
2x slack for data that stays in the 50 MB L2): a faster result raises
instead of being reported, as it can only mean that the calls were not
awaited. ``measure_chained`` times a carry -> carry function, such as a
train step, the same way.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from stylex_tpu_torch.device import map_tensors

__all__ = ["measure_op", "measure_chained", "OpTiming", "HBM_BYTES_PER_S"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
_ROOFLINE_SLACK = 2.0


@dataclass
class OpTiming:
    seconds: float  # per call, the median slope
    spread: float  # max - min of the slopes over repeats, seconds
    eff_bandwidth: Optional[float]  # bytes_moved / seconds, where given

    def __str__(self) -> str:
        s = f"{self.seconds * 1e6:9.2f}us (±{self.spread * 1e6:.2f})"
        if self.eff_bandwidth is not None:
            s += f" {self.eff_bandwidth / 1e9:6.0f}GB/s"
        return s


def _clock(device: torch.device):
    """``run(work) -> seconds`` on ``device``'s clock."""
    if device.type == "cuda":
        def run(work):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            work()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def run(work):
            t0 = time.perf_counter()
            work()
            return time.perf_counter() - t0
    return run


def _graphed(loop, n: int, device: torch.device):
    """``loop(n)`` captured as one CUDA graph; returns its replay. The
    warm-up runs on a side stream first, as capture needs."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        loop(2)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop(n)
    return graph.replay


def _slope(run, loop, n_pair: Tuple[int, int], repeats: int) -> OpTiming:
    n1, n2 = n_pair
    if not 0 < n1 < n2:
        raise ValueError(f"n_pair must be 0 < n1 < n2, got {n_pair}")
    run(lambda: loop(n1))  # warm: first-call costs, allocator, libraries
    run(lambda: loop(n2))
    slopes = []
    for _ in range(repeats):
        t1 = run(lambda: loop(n1))
        t2 = run(lambda: loop(n2))
        slopes.append(max((t2 - t1) / (n2 - n1), 1e-12))
    return OpTiming(statistics.median(slopes), max(slopes) - min(slopes), None)


def measure_op(fn: Callable, args: Sequence, *, n_pair: Optional[Tuple[int, int]] = None,
               repeats: int = 3, bytes_moved: Optional[int] = None,
               target_seconds: float = 0.2) -> OpTiming:
    """Per-call time of ``fn(*args)`` on the device that holds its first
    floating-point tensor argument.

    ``fn`` must return a tensor (or a tuple whose first item is one). The
    argument is copied once; the copy's first element is shifted by
    ``1e-6`` times the first element of each output before the next call.
    On a GPU ``fn`` must be capturable in a CUDA graph (no host reads) and
    ``n_pair`` defaults to (8, 40); on the CPU, without ``n_pair``, the
    lengths are set so that the long loop takes about ``target_seconds``.
    With ``bytes_moved`` (per call), a bandwidth above the roofline raises
    ``RuntimeError``.
    """
    args = list(args)
    idx = next((i for i, a in enumerate(args)
                if torch.is_tensor(a) and a.is_floating_point()), None)
    if idx is None:
        raise ValueError("measure_op needs a floating-point tensor argument to chain")
    x = args[idx].detach().clone()
    args[idx] = x
    carrier = x.view(-1)[:1]
    run = _clock(x.device)

    def loop(n: int) -> None:
        with torch.no_grad():
            for _ in range(n):
                out = fn(*args)
                out = out[0] if isinstance(out, (tuple, list)) else out
                carrier.add_(out.reshape(-1)[:1].to(x.dtype), alpha=1e-6)

    if x.is_cuda:
        n_pair = n_pair or (8, 40)
        replays = {n: _graphed(loop, n, x.device) for n in n_pair}
        timing = _slope(run, lambda n: replays[n](), n_pair, repeats)
    else:
        if n_pair is None:
            loop(2)
            est = max(run(lambda: loop(8)) / 8, 1e-7)
            n2 = int(min(max(target_seconds / est, 16), 4096))
            n_pair = (max(n2 // 4, 1), n2)
        timing = _slope(run, loop, n_pair, repeats)
    if bytes_moved is not None:
        timing.eff_bandwidth = bytes_moved / timing.seconds
        if timing.eff_bandwidth > HBM_BYTES_PER_S * _ROOFLINE_SLACK:
            raise RuntimeError(
                f"timing artifact: effective bandwidth {timing.eff_bandwidth / 1e9:.0f} GB/s "
                f"exceeds the HBM roofline ({HBM_BYTES_PER_S / 1e9:.0f} GB/s x "
                f"{_ROOFLINE_SLACK}): the calls were not awaited")
    return timing


def measure_chained(fn: Callable, carry0, *, n_pair: Tuple[int, int] = (2, 8),
                    repeats: int = 3) -> OpTiming:
    """Per-call time of ``fn(i, carry) -> carry`` (e.g. a train step),
    iterated so that each call consumes the last one's output; the carry
    also chains across the timed runs. The clock is that of the device of
    the carry's first tensor (the CPU's where it has none)."""
    devices = []
    map_tensors(carry0, lambda t: devices.append(t.device))
    dev = devices[0] if devices else torch.device("cpu")
    state = {"carry": carry0}

    def loop(n: int) -> None:
        c = state["carry"]
        for i in range(n):
            c = fn(i, c)
        state["carry"] = c

    return _slope(_clock(dev), loop, n_pair, repeats)
