"""Device-time breakdown of one AttFind sweep chunk on the GPU.

    python -m stylex_tpu_torch.profile_sweep [--start-block 0]
        [--out chiprun_out/profile_sweep.json]

Builds the 64px config in bfloat16 (random weights from seed 0,
MobileNetV2), runs phase 1 for 4 synthetic images, then times one sweep
chunk of 616 perturbations (the size ``chip_smoke.py`` runs) with CUDA
events (median of 5 runs of 10 chunks, after warm-up) and traces 3 chunks
with ``torch.profiler``. Prints the device time per kernel name (per
chunk), the device's busy share of the traced window, and the share of the
package's own kernels. ``--start-block k`` profiles a block-resume chunk
(resumed from block k's cached states); 0 is the flat sweep's chunk.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_summary(prof, reps: int, window_ms: float):
    """From a ``torch.profiler`` trace of ``reps`` repetitions over
    ``window_ms`` of wall time: device time per kernel name per repetition
    (sorted), its sum, the device's busy share of the window, and the
    package's own kernels' time per repetition."""
    from torch.autograd import DeviceType

    # the device's own events (kernels, copies, memsets) only: the operator
    # events that launch them carry the same time again, and so do the
    # user annotations on the device's timeline (e.g. "Optimizer.step")
    device_events = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    per_name = {}
    for e in device_events:
        us, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = [dict(name=k, ms_per_rep=us / 1e3 / reps, calls_per_rep=n / reps)
            for k, (us, n) in per_name.items()]
    rows.sort(key=lambda r: -r["ms_per_rep"])
    device_ms = sum(r["ms_per_rep"] for r in rows)
    # busy: the union of the device events' intervals, over the wall window
    busy_us, last_end = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in device_events):
        busy_us += max(0.0, end - max(start, last_end))
        last_end = max(last_end, end)
    ours = {k: sum(r["ms_per_rep"] for r in rows if symbol in r["name"])
            for k, symbol in OWN_KERNELS.items()}
    return rows, device_ms, busy_us / 1e3 / window_ms, ours


# the package's kernels: name -> a substring of their symbols (csrc/*.cu;
# blur3_kernel is both blur variants)
OWN_KERNELS = {"upsample2x_bilinear": "upsample2x_bilinear_kernel", "blur3": "blur3_kernel",
               "im2col": "im2col_kernel", "col2im": "col2im_kernel",
               "frozen_bn": "frozen_bn_kernel"}

# kernel kinds by name, first match wins (cuDNN's layout transposes first)
KINDS = (
    ("hand-written kernels", tuple(OWN_KERNELS.values())),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolution and GEMM", ("xmma", "convolve", "cudnn", "gemm", "fft", "wgrad", "dgrad",
                              "conv_depthwise", "cutlass", "pointwise_mult_and_sum_complex")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise, copy, fill", ("elementwise", "copy", "Fill")),
)


def by_kind(rows):
    """Device ms per repetition summed by kernel kind."""
    out = {kind: 0.0 for kind, _ in KINDS}
    out["other"] = 0.0
    for r in rows:
        kind = next((k for k, keys in KINDS if any(key in r["name"] for key in keys)), "other")
        out[kind] += r["ms_per_rep"]
    return out


def print_summary(rows, device_ms: float, ours, unit: str, top: int) -> None:
    for kind, ms in by_kind(rows).items():
        print(f"  {kind}: {ms:.4f} ms/{unit} ({ms / device_ms if device_ms else 0:.3f})")
    for k, v in ours.items():
        print(f"  {k}: {v:.4f} ms/{unit} ({v / device_ms if device_ms else 0:.3f} of device time)")
    for r in rows[:top]:
        print(f"  {r['ms_per_rep']:9.4f} ms  x{r['calls_per_rep']:5.1f}  {r['name'][:110]}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--start-block", type=int, default=0)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default=None, help="write the table as JSON here")
    args = p.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from stylex_tpu_torch.attfind.extraction import _sweep_chunk
    from stylex_tpu_torch.config import ModelConfig
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.device import resolve_device
    from stylex_tpu_torch.models import build_classifier, build_stylex
    from stylex_tpu_torch.ops.fusion import prefer_literal_resample
    from stylex_tpu_torch.ops.latents import image_noise

    device = resolve_device(None)
    dtype = torch.bfloat16
    cfg = ModelConfig()
    model = build_stylex(cfg, seed=0, device=device).to(dtype)
    clf = build_classifier("mobilenet", cfg.image_size, seed=0, device=device).to(dtype)
    n_img, cb = 4, 616
    ds = SyntheticImageDataset(n_img, cfg.image_size)
    images = torch.from_numpy(np.stack([ds[i] for i in range(n_img)]).transpose(0, 3, 1, 2).copy())
    noise = image_noise(torch.Generator().manual_seed(42), 1, cfg.image_size).to(device, dtype)

    # the sweep's graph: literal resampling, as attfind_extraction runs it
    with torch.no_grad(), prefer_literal_resample():
        w, coords, _, base, states, _ = model.sweep_phase1(images.to(device, dtype),
                                                           clf.classify_images, noise, True)
        mins, maxs = coords.min(0).values, coords.max(0).values
        ar = torch.arange(cb, device=device)
        lo = sum(i + o for i, o in model.G.block_dims[:args.start_block])
        size = sum(model.G.block_dims[args.start_block])
        img, coord, is_max = ar % n_img, lo + ar % size, ar % 2 == 1
        block_states = states[args.start_block] if args.start_block > 0 else None

        def chunk():
            return _sweep_chunk(model, clf.classify_images, w, noise, coords, mins, maxs, base,
                                img, coord, is_max, 1.0, args.start_block, block_states)

        for _ in range(3):
            chunk()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                chunk()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 10)
        chunk_ms = statistics.median(times)

        reps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                chunk()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3

    rows, device_ms, busy_share, ours = device_summary(prof, reps, window_ms)
    card = card_line()
    print(f"{card} | bfloat16 | coord_batch {cb} | start_block {args.start_block}")
    print(f"chunk: {chunk_ms:.4f} ms (CUDA events) = {cb / chunk_ms * 1e3:.1f} styles/s; "
          f"traced device time {device_ms:.4f} ms/chunk over "
          f"{sum(r['calls_per_rep'] for r in rows) * reps:.0f} device events; "
          f"device busy {busy_share:.3f} of the traced window")
    print_summary(rows, device_ms, ours, "chunk", args.top)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, dtype="bfloat16", coord_batch=cb, start_block=args.start_block,
            chunk_ms=chunk_ms, device_ms_per_chunk=device_ms,
            busy_share=busy_share, ours_ms_per_chunk=ours, by_kind=by_kind(rows), rows=rows,
        ), indent=1))


if __name__ == "__main__":
    main()
