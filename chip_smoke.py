"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device and build: needs CUDA; prints the card's name and power limit;
   builds every CUDA kernel of the package from its sources.
2. Each kernel against its plain PyTorch version on the card, float32 and
   bfloat16, at the shapes the AttFind main path and the training path
   (phase 5) give it, and the upsample at those of Google's 256-px
   generator (phase 10: one literal-graph forward's calls, summed apart,
   and the fused graph's widest border strips), at small and odd
   widths, and on an input one element into its storage (misaligned): max
   abs error against the stated tolerance. Then CUDA-event times per call
   of the kernel's wrapper, the plain version and the one-call PyTorch
   yardstick (host cost included); the kernel's device time alone (a CUDA
   graph of 20 calls, replayed); the wrapper's host cost (host clock over
   200 calls, no synchronise); and the least time the card's memory and
   float32 arithmetic rates allow.
3. The main path at full width: AttFind extraction at the 64px config
   (2464 StyleSpace coordinates, MobileNetV2 classifier, random weights from
   a seed), bfloat16, 4 images, ``coord_batch=616``; the block-resume sweep,
   then the flat sweep. Each run starts with the launch counts at 0 and must
   launch every kernel; the two agree to a stated bf16 bound. Both sweeps
   then run in float32, where they must agree closely.
4. The card against the CPU: phase 1 for 2 images and one 32-element sweep
   chunk, float32 with TF32 off, the same weights on both.
5. The training path at full width: the CLI's defaults (64px, capacity 16,
   OLD arch, ResNet-18 classifier, batch 4 x 8 micro-batches, the 512-image
   synthetic set), float32, 6 ``Trainer.train()`` steps (each step's
   metrics as the trainer logs them) with GP at steps 0
   and 4, PL at step 4, the EMA reset at step 2 and an EMA update at step 4,
   on the default (fused) resample graph, then the same 6 steps forced onto
   the literal graph (``prefer_literal_resample``). Losses must stay
   finite, the weights move, and the upsample and blur kernels launch in
   both. Then 2 bfloat16 steps (fused), which must stay finite. Each run
   reports ms/step, peak memory and launches.
6. Precision against a float64 witness on the CPU: the trainable convs of
   the step alone (output, input and weight gradients; the im2col path
   held, cuDNN reported), then one train step on the default (fused) graph
   at full width, batch 2 x 2, float32 with TF32 off, GP and PL on, the
   same weights and draws on the CPU in float64 and float32 and on the
   card. As trained, the step has kinks (leaky ReLU, ReLU, max pooling)
   at which float32 rounding flips single activations: its losses are
   held, its gradients reported beside the CPU's own spread under a 1e-6
   weight perturbation and the card with every convolution in cuDNN. With
   the kinks smoothed (``smooth_kinks``) losses and gradients per tree of
   both float32 runs against the witness and of the card against the CPU
   are held.
7. The model and step options at full width: ``ModelConfig()`` with
   attention (``attn_layers=(1, 2)``), the ``no_const`` stem and a quantize
   layer (``fq_layers=(2,)``), trained with ``cl_reg`` by the scan step
   (``fused_microbatches=False``), float32, 3 ``Trainer.train()`` steps:
   losses finite, weights and the codebook moving, both kernels launched.
   One step of that configuration at batch 2 x 2 on the card against the
   CPU (held as in phase 6), and one forward of the
   ``PhillipEncoder64`` debug encoder on the card.
8. Evaluation, float32 with TF32 off, the InceptionV3 weights the port's
   seeded init saved as a torchvision-layout file and read through
   ``STYLEX_TPU_INCEPTION``: (a) pool3 features of 4 generated images,
   card against CPU (1e-3 x max|f|), and images/s at batch 64; (b) on
   phase 3's float32 model and records (effects rescaled so that the
   filter probes D), the filtered greedy search, the counterfactual images
   for k = 1..3 card against CPU (1e-4), and ``fid_topk`` with k = 3
   (finite FIDs, ``fid_results.csv``; ``frechet_distance`` timed apart),
   launching both kernels; (c) ``Trainer.train()`` at the CLI defaults
   with FID every 2 steps over 256 images for 3 steps (one
   ``fid_scores.txt`` line, after step 2), a second FID from the cached
   real statistics, an 8-frame interpolation GIF; (d) ``replay_results``
   on phase 3's records with (c)'s checkpoint and one user study at
   512-pixel panels.
9. Weights in and out at full width, float32 with TF32 off unless stated:
   (a) phase 5's float32 trainer (Adam moments and ``pl_mean`` set) saved
   as the JAX package's ``model_1.ckpt`` and loaded by ``Trainer.load(1)``
   into a fresh trainer: every parameter, buffer, Adam moment and count,
   the step and ``pl_mean`` equal bit for bit; one train step from each on
   the same batch and draws, losses and parameters within phase 6's
   tolerance; (b) ``Trainer.load(1, inference=True, ship_ema=False,
   param_dtype=bfloat16)`` (device memory against the full load's,
   ``train()`` refused), then ``run_attfind --name --load-from 1 --dtype
   bfloat16`` on 4 synthetic images with ResNet-18, its records equal bit
   for bit to ``attfind_extraction`` on the source's live nets cast to
   bfloat16; (c) MobileNetV2, LPIPS and InceptionV3 ``.msgpack`` trees
   written by ``ingest`` and read back, outputs equal to the ``.pt``
   route's; (d) ``train_classifier --dataset synthetic``, MobileNetV2 at
   64 px for one epoch and ResNet-18 at 224 px progressively for three,
   the saved ``classifier.msgpack`` reproducing the trainer's validation
   logits; (e) ``run_counterfactual`` with phase 3's model saved as a
   ``.ckpt`` on phase 8's records, ``fid_results.csv`` equal to phase 8's.

10. Google's published StylEx generator and the host loop, float32 with
   TF32 off unless stated: (a) ``GoogleStylExGenerator()`` at 256 px
   (fmap_base 8192, dlatent 514, seeded weights), batch 8: the upsample
   kernel's launches per forward on the fused and the literal graph
   against the count derived from the code, card against CPU and fused
   against literal within 1e-4 x max|image|, ``style_delta`` zero and
   one-hot, bf16 finite, ms and peak memory per forward in float32 and
   bf16; (b) ``ingest_tf.google_fid_topk`` with the port's generator, a
   stand-in model pair (its style vectors, the seeded MobileNetV2) and the
   seeded InceptionV3, 16 originals, k = 1: finite FIDs and their seconds;
   (c) the CLI-default trainer for 8 steps in blocks of 4 with
   ``metrics_lag=8`` and ``async_save``, and one step at a time
   synchronously: block sizes, logged steps, losses within phase 6's rtol,
   the background checkpoint equal bit for bit to the state at its save,
   wall ms/step and the device's busy share; (d) ``run_attfind
   --chunks-per-dispatch`` 8 against 1 on 4 images: records equal,
   styles/s; (e) the C++ pixel pipeline built and taken by
   ``load_and_transform``, equal to PIL within 2.5/255, and ``measure_op``
   on the upsample at the sweep-chunk shapes within 2x of phase 2's device
   ms, under the roofline guard; (f) one block-resume AttFind sweep at the
   parameters of each 256-px sweep cell (``coord_batch`` 512, MobileNetV2
   at 256 px): Google's generator over 1 dlatent and the ``ffhq256``
   StylEx over 4 images, each kernel call's shape recorded, Google's
   upsample calls against the count derived from the code; then the
   upsample at every distinct shape the two sweeps gave it, up to outputs
   of 4.3e9 elements, against its plain version bit for bit, with its ms
   and share of the bytes bound.

11. Data parallelism on the one card, float32 with TF32 off: (a) the
   CLI-default trainer (ResNet-18, batch 4 x 8) as one process, as a
   group of one under NCCL and as two ranks sharing the card under gloo
   (2 images a rank per micro-batch): one plain train step from the seeded
   weights (metrics and parameters against one process as trained,
   gradients with the kinks smoothed), then 5
   ``Trainer.train()`` steps (step 0's losses against one process, every
   rank's state after step 4 bit-equal to rank 0's, both kernels launched
   in every rank, ms/step, the gradient all-reduce's bytes and ms per
   step); (b) ``run_attfind --name`` at phase 3's config in float32 on two
   ranks against one process: records within phase 3's float32 bound,
   both kernels launched in every rank, styles/s. Two ranks sharing one
   card are no speed figure.

12. The convolution's column kernels (``csrc/im2col.cu``, ``csrc/col2im.cu``,
   ``ops/conv.py``), float32 with TF32 off, at the main path's shapes at
   batch 32 (``ffhq256.train``: D's 64-channel 3x3 at 256 px and its fused
   5x5 stride-2 downsample over the padded 259x259 map, G's 32-channel 3x3
   at 256 px) and at small, ragged, strided and grouped ones (a depthwise
   3x3 stride 2 at MobileNetV2's shape, which no cell runs): each kernel
   against its plain version bit for bit, the columns position-major and
   col2im from a position-major and a row-major gradient, and
   ``conv2d_gemm`` against the im2col of PR 2 (pad, unfold, copy,
   differentiated by autograd) bit for bit in the output, the first
   derivatives and the gradient penalty's second derivative; kernel ms,
   device ms, the bytes bound, plain ms (position-major too) and the
   library's ``F.unfold`` / ``F.fold`` ms (row-major) at the main shapes,
   which the ``kernels`` line sums; then one
   ``Trainer.train()`` step at the CLI defaults, float32 (a GP step), which
   must launch both, while no-grad and bfloat16 convolutions launch
   neither.

13. The classifiers' batch-norm kernel (``csrc/frozen_bn.cu``,
   ``ops/frozen_bn.py``), float32 and bfloat16: at every batch norm of
   MobileNetV2 at 512 x 256 px and 512 x 64 px (with its ReLU6 and
   residual add) against the plain chain bit for bit, with its ms, device
   ms, host microseconds, the device ms's share of the bytes bound, the
   plain chain's and ``F.batch_norm``'s ms, and NaN and infinite inputs;
   one classifier forward on a sweep chunk at each size and dtype fused
   and on the plain chain, logits equal bit for bit, 52 layers on each
   path; a sweep at the 64-px config in each dtype with every classifier
   forward fused and records equal to the plain chain's; one train step at
   the CLI defaults with MobileNetV2, its autograd forwards on the plain
   chain. Phase 3's bfloat16 sweeps must launch the kernel too.

Phase 2 also holds the blur fused with 2x decimation, which no path runs,
at the D/E shapes of training. The script prints a ``kernels`` JSON line
and, last, the ``ok`` JSON line. Details go to
``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --kernels-only [--package-root DIR --tag T]

runs phases 1-2 alone; with ``--package-root`` it times the kernels of
another checkout (an unpacked parent commit) with this script's phase 2.
``python3 chip_smoke.py --conv-only`` runs phases 1 and 12 alone (details
in ``chiprun_out/chip_smoke_conv.json``); ``--bn-only`` phases 1 and 13
(``chiprun_out/chip_smoke_bn.json``); ``--google-only`` phases 1, 2
and 10 (details in ``chiprun_out/chip_smoke_google.json``).
``python3 chip_smoke.py --parallel-only [--cards N]`` runs phases 1 and
11 alone; with ``--cards N`` phase 11 also runs on N cards, one rank each
(NCCL), for a machine with that many.
"""

import argparse
import contextlib
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

COORD_BATCH = 616
N_IMAGES = 4
F32_TOL = 1e-6  # kernel and plain version do the same float ops: expect 0
CPU_RTOL, CPU_ATOL = 1e-3, 1e-4  # cuDNN and the CPU sum convolutions in other orders
TRAIN_BATCH = 32  # images per train step at the CLI defaults: 4 x 8 micro-batches
GOOGLE_BATCH = 8  # Google's 256-px generator in phase 10
SWEEP_COORD_BATCH = 512  # the 256-px sweep cells' chunk, in phase 10 (f)
# the kernels that AttFind and training run; blur3_downsample2x is on no path
ON_PATH = ("upsample2x_bilinear", "blur3")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peak_rates(name: str):
    """Published (HBM bytes/s, float32 FLOP/s outside the tensor cores) of
    the named card; the kernels do their arithmetic in float32."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12  # H100 SXM


def time_ms(fn, x, reps: int = 20, loops: int = 5) -> float:
    """Median over ``loops`` of the CUDA-event time of ``reps`` calls / reps:
    the time per call with the host's cost, as a caller meets it."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, x, reps: int = 20, loops: int = 5) -> float:
    """Median over ``loops`` of the CUDA-event time of one replay of a CUDA
    graph that holds ``reps`` calls, / reps: the device's time per call,
    without the host's."""
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
            for _ in range(3):
                fn(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn(x)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def host_us(fn, x, calls: int = 200) -> float:
    """Host-clock microseconds per call over ``calls`` calls, with no
    synchronise between them: the host's cost of one call."""
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(x)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bf16_ulp(magnitude: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(magnitude, 1e-30))) - 7)


# ------------------------------------------------------------------ phase 2


def kernel_shapes():
    """Phase 2's input shapes per kernel: ``chunk``, one AttFind sweep
    chunk's calls (blur3_downsample2x: the D/E maps of one 32-image training
    phase), which the ``kernels`` line sums; ``extra``, the other shapes of
    the paths; ``ragged``, small and odd sizes; ``offset``, shapes whose
    input is a contiguous view one element into its storage (misaligned)."""
    b = COORD_BATCH
    up_shapes = [(b, 512, 4, 4), (b, 256, 8, 8), (b, 128, 16, 16), (b, 64, 32, 32),
                 (b, 3, 4, 4), (b, 3, 8, 8), (b, 3, 16, 16), (b, 3, 32, 32)]
    blur_shapes = [(b, 3, 8, 8), (b, 3, 16, 16), (b, 3, 32, 32), (b, 3, 64, 64)]
    # D/E pre-blur in phase 1 (4 images per phase-1 batch)
    blur_phase1 = [(N_IMAGES, 64, 64, 64), (N_IMAGES, 128, 32, 32), (N_IMAGES, 256, 16, 16),
                   (N_IMAGES, 512, 8, 8), (N_IMAGES, 512, 4, 4)]
    up_256px = [(4, 64, 128, 128)]
    # Google's generator at 256 px, batch 8 (phase 10): one forward's calls
    # on the literal graph (the block entries, then the RGB skips), and the
    # border strips of the fused graph's largest block entry
    gb = GOOGLE_BATCH
    gen256 = ([(gb, c, r, r) for c, r in ((512, 4), (512, 8), (512, 16), (512, 32), (256, 64),
                                          (128, 128))]
              + [(gb, 3, r, r) for r in (4, 8, 16, 32, 64, 128)])
    strips256 = [(gb, 128, 3, 128), (gb, 128, 128, 3)]
    # training at the CLI defaults (phase 5): the D/E full-resolution maps
    # before each stride-2 conv, at 64px (capacity 16)
    de_maps = [(64, 64, 64), (128, 32, 32), (256, 16, 16), (512, 8, 8), (512, 4, 4)]
    t = TRAIN_BATCH
    down_train = [(t, *m) for m in de_maps]
    # D over [fake; real] in the D phase (2 x 32), D in GP and the G phase
    # (32; GP's double backward blurs the same shapes), E over the encoder
    # micro-batches (4 of 8, 16 images); G's RGB-skip blur at 32
    blur_train = ([(2 * t, *m) for m in de_maps] + down_train + [(t // 2, *m) for m in de_maps]
                  + [(t, 3, s, s) for s in (8, 16, 32, 64)])
    # G's block-entry and RGB-skip upsamples at 32
    up_train = [(t, *s[1:]) for s in up_shapes]
    return {
        "upsample2x_bilinear": dict(
            chunk=up_shapes, extra=up_256px + up_train + strips256, gen256=gen256,
            ragged=[(8, 3, 4, 1), (8, 3, 4, 2), (8, 3, 3, 5), (8, 3, 1, 4), (8, 3, 1, 1)],
            offset=[(8, 3, 16, 16)]),
        "blur3": dict(
            chunk=blur_shapes, extra=blur_phase1 + blur_train,
            ragged=[(8, 3, 2, 2), (8, 3, 5, 7), (8, 3, 2, 6), (8, 3, 7, 3)],
            offset=[(8, 3, 16, 16)]),
        "blur3_downsample2x": dict(
            chunk=down_train, extra=[],
            ragged=[(8, 3, 2, 2), (8, 3, 6, 10), (8, 3, 4, 12)],
            offset=[(8, 3, 16, 16)]),
    }


def kernel_phase(card: str, rates):
    import torch.nn.functional as F

    from stylex_tpu_torch.ops import blur as ops

    def blur_library(x, stride=1):
        k = x.new_tensor([1.0, 2.0, 1.0])
        k = (k[:, None] * k[None, :] / 16.0).expand(x.shape[1], 1, 3, 3)
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k, groups=x.shape[1],
                        stride=stride)

    specs = {
        "upsample2x_bilinear": dict(
            wrapper=ops.upsample2x_bilinear, plain=ops.upsample2x_bilinear_plain,
            library=lambda x: F.interpolate(x, scale_factor=2, mode="bilinear",
                                            align_corners=False),
            # read x, write 4x; 3 two-tap sums (2 mul + 1 add) per output
            bytes_per_in=5, flops_per_in=4 * 9),
        "blur3": dict(
            wrapper=ops.blur3, plain=ops.blur3_plain, library=blur_library,
            # read x, write x; 4 three-tap sums (3 mul + 2 add) per output
            bytes_per_in=2, flops_per_in=4 * 5),
        "blur3_downsample2x": dict(
            wrapper=ops.blur3_downsample2x, plain=ops.blur3_downsample2x_plain,
            library=lambda x: blur_library(x, stride=2),
            # read x, write a quarter; 4 three-tap sums per kept output
            bytes_per_in=1.25, flops_per_in=4 * 5 / 4),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, summary = [], {}
    for name, shapes in kernel_shapes().items():
        sp = specs[name]
        summary[name] = dict(max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                             library_ms=0.0, bound_by=set(), host_us=[], host_us_grad=[])
        # (shape, group, storage offset of the input in elements)
        cases = [(s, group, int(group == "offset")) for group, ss in shapes.items() for s in ss]
        for dtype in (torch.float32, torch.bfloat16):
            for shape, group, offset in cases:
                numel = int(np.prod(shape))
                x = torch.randn(numel + offset, generator=gen, device="cuda").to(dtype)
                x = x[offset:].view(shape)
                y = sp["wrapper"](x)
                want = sp["plain"](x)
                torch.cuda.synchronize()
                err = (y.float() - want.float()).abs().max().item()
                mag = want.float().abs().max().item()
                tol = F32_TOL if dtype == torch.float32 else bf16_ulp(mag)
                ok = err <= tol and y.shape == want.shape and bool(torch.isfinite(y).all())
                byte_ms = sp["bytes_per_in"] * x.numel() * x.element_size() / rates[0] * 1e3
                flop_ms = sp["flops_per_in"] * x.numel() / rates[1] * 1e3
                bound = max(byte_ms, flop_ms)
                bound_by = "bytes" if byte_ms >= flop_ms else "operations"
                with torch.no_grad():  # as the AttFind sweep calls it
                    h_us = host_us(sp["wrapper"], x)
                with torch.enable_grad():  # as training calls it: through the autograd Function
                    h_us_grad = host_us(sp["wrapper"], x.detach().requires_grad_(True))
                row = dict(kernel=name, dtype=str(dtype).split(".")[-1], shape=list(shape),
                           group=group, storage_offset=offset, max_abs_err=err, tol=tol, ok=ok,
                           ms=time_ms(sp["wrapper"], x), device_ms=device_ms(sp["wrapper"], x),
                           host_us=h_us, host_us_grad=h_us_grad,
                           plain_ms=time_ms(sp["plain"], x),
                           library_ms=time_ms(sp["library"], x), bound_ms=bound,
                           bound_by=bound_by)
                row["device_bound_share"] = bound / row["device_ms"]
                rows.append(row)
                log(f"  {name:20s} {row['dtype']:8s} {str(tuple(shape)):22s}{'+1' if offset else '  '} "
                    f"err={err:.3g} (tol {tol:.3g}) ms={row['ms']:.4f} "
                    f"device_ms={row['device_ms']:.4f} ({row['device_bound_share']:.3f} of bound) "
                    f"host_us={h_us:.2f}/{h_us_grad:.2f} plain={row['plain_ms']:.4f} "
                    f"library={row['library_ms']:.4f} bound={bound:.4f} ({bound_by}) [{card}]")
                if not ok:
                    raise AssertionError(f"{name} {row['dtype']} {shape}+{offset}: "
                                         f"error {err} > {tol}")
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                s["host_us"].append(h_us)
                s["host_us_grad"].append(h_us_grad)
                if group == "chunk" and dtype == torch.bfloat16:
                    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms"):
                        s[key] += row[key]
                    s["bound_by"].add(bound_by)
                if group == "gen256":  # one literal-graph forward's calls, per dtype
                    g = s.setdefault(f"gen256_{row['dtype']}", dict(
                        calls=0, ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        library_ms=0.0))
                    g["calls"] += 1
                    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms"):
                        g[key] += row[key]
    for s in summary.values():  # median host cost per call over every shape
        s["host_us"] = statistics.median(s["host_us"])
        s["host_us_grad"] = statistics.median(s["host_us_grad"])
    return rows, summary, host_breakdown(ops, card)


def host_breakdown(ops, card: str):
    """Where a wrapper call's host time goes: host microseconds per call of
    its parts, one upsample at (616, 3, 4, 4) bf16 under no_grad (device
    time 2 µs: launch-bound), beside one eager PyTorch op on the same
    tensor."""
    x = torch.randn(COORD_BATCH, 3, 4, 4, device="cuda").to(torch.bfloat16)
    out = (COORD_BATCH, 3, 8, 8)
    name = "upsample2x_bilinear"
    parts = {
        "torch.empty": lambda x: torch.empty(out, dtype=x.dtype, device=x.device),
        "_launch (checks, empty, geometry, C call)": lambda x: ops._launch(name, x, out),
        "wrapper": ops.upsample2x_bilinear,
        "one eager op (torch.neg)": torch.neg,
    }
    with torch.no_grad():
        got = {k: host_us(fn, x, calls=2000) for k, fn in parts.items()}
    log("  host us per call: " + ", ".join(f"{k} {v:.2f}" for k, v in got.items()) + f" [{card}]")
    return got


# ------------------------------------------------------------------ phase 3


def main_path_phase(card: str):
    from stylex_tpu_torch.attfind import attfind_extraction, rank_styles
    from stylex_tpu_torch.config import ModelConfig
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.models import build_classifier, build_stylex
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.ops.latents import image_noise

    cfg = ModelConfig()
    nets = {}
    for dtype in (torch.bfloat16, torch.float32):
        nets[dtype] = (build_stylex(cfg, seed=0).to(dtype),
                       build_classifier("mobilenet", cfg.image_size, seed=0).to(dtype))
    C = nets[torch.float32][0].total_style_coords
    if C != 2464:
        raise AssertionError(f"expected 2464 style coordinates at 64px, got {C}")
    ds = SyntheticImageDataset(N_IMAGES, cfg.image_size)
    images = np.stack([ds[i] for i in range(N_IMAGES)])
    noise = image_noise(torch.Generator().manual_seed(42), 1, cfg.image_size).numpy()

    def run(block_resume: bool, dtype=torch.bfloat16):
        model, clf = nets[dtype]
        return attfind_extraction(model, clf.classify_images, images, noise,
                                  coord_batch=COORD_BATCH, block_resume=block_resume,
                                  compute_dtype=dtype, progress=False)

    # warm-up at the measured shapes: cuDNN, cuBLAS and allocator first use
    run(True)
    run(False)
    out = {}
    for label, resume in (("resume", True), ("flat", False)):
        reset_launches()
        t0 = time.perf_counter()
        rec = run(resume)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        styles = rec.style_change.shape[0] * 2 * rec.style_change.shape[2]
        sweep_start = rec.stage_walls["capture_states" if resume else "phase1"]
        sweep_end = rec.stage_walls["block4" if resume else "sweep"]
        out[label] = dict(records=rec, launches=launches, wall_s=wall,
                          styles_per_s=styles / wall,
                          sweep_styles_per_s=styles / (sweep_end - sweep_start),
                          stage_walls=rec.stage_walls)
        log(f"  {label}: {styles} styles in {wall:.4f} s = {styles / wall:.1f} styles/s "
            f"(sweep stages alone {out[label]['sweep_styles_per_s']:.1f} styles/s) "
            f"launches={launches} [{card}]")
        log(f"  {label} stage_walls (s since start) = {json.dumps(rec.stage_walls)} [{card}]")
        if rec.style_change.shape != (N_IMAGES, 2, C, cfg.num_classes):
            raise AssertionError(f"style_change shape {rec.style_change.shape}")
        for f in ("style_change", "latents", "base_prob", "minima", "maxima",
                  "style_coordinates", "discriminator"):
            if not np.isfinite(getattr(rec, f)).all():
                raise AssertionError(f"{label}: non-finite {f}")
        for name in ON_PATH:
            if launches[name] <= 0:
                raise AssertionError(f"{label}: kernel {name} was not launched on the main path")
        if launches["frozen_bn"] <= 0:  # the classifier's batch norms, bfloat16
            raise AssertionError(f"{label}: the classifier launched no frozen_bn")

    checks = {}
    # float32 (TF32 off): the two sweeps compute the same function, so they
    # agree up to cuDNN's batch-dependent summation order (the resume states
    # come from a batch-4 forward, the flat sweep recomputes them at 616)
    r32, f32 = run(True, torch.float32), run(False, torch.float32)
    d32 = np.abs(r32.style_change - f32.style_change)
    checks["f32_resume_vs_flat_max_abs"] = float(d32.max())
    log(f"  f32 resume vs flat: max |diff| {d32.max():.4g} (rtol {CPU_RTOL}, atol {CPU_ATOL}); "
        f"max |effect| {np.abs(f32.style_change).max():.4g}")
    if (d32 - (CPU_ATOL + CPU_RTOL * np.abs(f32.style_change))).max() > 0:
        raise AssertionError("f32 resume and flat sweeps disagree")
    # bf16: the resume states come from a batch-4 forward, the flat sweep
    # recomputes them at batch 616, and cuDNN rounds the two differently.
    # Between w and a logit lie ~200 bf16-rounded ops; errors of two
    # independently rounded pipelines grow like sqrt(200) ~ 14 ulps each,
    # so the two sweeps agree to 32 bf16 ulps of the largest |logit|.
    a, b = out["resume"]["records"], out["flat"]["records"]
    d16 = float(np.abs(a.style_change - b.style_change).max())
    tol16 = 32 * bf16_ulp(float(np.abs(a.base_prob).max()))
    checks["bf16_resume_vs_flat_max_abs"] = d16
    checks["bf16_resume_vs_flat_tol"] = tol16
    log(f"  bf16 resume vs flat: max |diff| {d16:.4g} (tol {tol16:.4g} = 32 bf16 ulps of "
        f"max |logit|); max |effect| {float(np.abs(a.style_change).max()):.4g}")
    if not d16 <= tol16:
        raise AssertionError(f"bf16 resume and flat sweeps disagree: {d16} > {tol16}")
    # reported, not gated: how far bf16 rounding noise is below the effects
    m32 = f32.style_change.mean(axis=0)
    for label in ("resume", "flat"):
        m16 = out[label]["records"].style_change.mean(axis=0)
        corr = float(np.corrcoef(m16.ravel(), m32.ravel())[0, 1])
        checks[f"bf16_{label}_vs_f32_mean_max_abs"] = float(np.abs(m16 - m32).max())
        checks[f"bf16_{label}_vs_f32_mean_corr"] = corr
        log(f"  bf16 {label} vs f32 flat, mean effects: max |diff| "
            f"{checks[f'bf16_{label}_vs_f32_mean_max_abs']:.4g}, corr {corr:.4f}; "
            f"max |f32 mean effect| {float(np.abs(m32).max()):.4g}")
    ranked, _ = rank_styles(a)
    if not ranked or not all(len(p) == 2 for p in ranked):
        raise AssertionError(f"rank_styles returned {ranked}")
    log(f"  ranked (direction, sindex): bf16 resume {ranked}, "
        f"f32 flat {rank_styles(f32)[0]}")
    return out, checks, ranked, (nets[torch.float32], r32)


# ------------------------------------------------------------------ phase 4


def card_vs_cpu_phase():
    """On the sweep's graph: the literal resample, as attfind_extraction
    runs it."""
    from stylex_tpu_torch.ops.fusion import prefer_literal_resample

    with prefer_literal_resample():
        return _card_vs_cpu()


def _card_vs_cpu():
    from stylex_tpu_torch.attfind.extraction import _sweep_chunk
    from stylex_tpu_torch.config import ModelConfig
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.device import set_float32_precision
    from stylex_tpu_torch.models import build_classifier, build_stylex
    from stylex_tpu_torch.ops.latents import image_noise

    set_float32_precision()
    cfg = ModelConfig()
    ds = SyntheticImageDataset(2, cfg.image_size, seed=1)
    images = torch.from_numpy(np.stack([ds[i] for i in range(2)]).transpose(0, 3, 1, 2).copy())
    noise = image_noise(torch.Generator().manual_seed(7), 1, cfg.image_size)
    results = {}
    for dev in ("cpu", "cuda"):
        model = build_stylex(cfg, seed=1, device=dev)
        clf = build_classifier("mobilenet", cfg.image_size, seed=1, device=dev)
        with torch.no_grad():
            x, nz = images.to(dev), noise.to(dev)
            w, coords, d, base, _, _ = model.sweep_phase1(x, clf.classify_images, nz, False)
            n = 32
            img_idx = torch.arange(n, device=dev) % 2
            coord_idx = torch.arange(n, device=dev) * 77 % model.total_style_coords
            is_max = torch.arange(n, device=dev) % 2 == 1
            eff = _sweep_chunk(model, clf.classify_images, w, nz, coords,
                               coords.min(0).values, coords.max(0).values, base,
                               img_idx, coord_idx, is_max, 1.0)
        results[dev] = {k: v.cpu().numpy() for k, v in
                        dict(w=w, coords=coords, d=d, base=base, effects=eff).items()}
    errs = {}
    for k in results["cpu"]:
        got, want = results["cuda"][k], results["cpu"][k]
        errs[k] = float(np.abs(got - want).max())
        excess = np.abs(got - want) - (CPU_ATOL + CPU_RTOL * np.abs(want))
        log(f"  card vs cpu {k:8s}: max abs err {errs[k]:.4g} (rtol {CPU_RTOL}, atol {CPU_ATOL})")
        if excess.max() > 0:
            raise AssertionError(f"card and CPU disagree on {k}: max abs err {errs[k]}")
    return errs


# ------------------------------------------------------------------ phase 5


def _cuda_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _logged_metrics(trainer) -> dict:
    """step -> the metrics the trainer logs for it, collected as it logs
    them: with ``metrics_lag`` (the default) ``train()`` returns the latest
    metrics read, which may be an earlier step's."""
    logged = {}
    inner = trainer.logger.log

    def log_and_keep(step, metrics):
        logged[step] = dict(metrics)
        inner(step, metrics)

    trainer.logger.log = log_and_keep
    return logged


def _train_run(card: str, base: Path, label: str, model_cfg, tc, n_steps: int,
               literal: bool = False, moving=None):
    """``n_steps`` of ``Trainer.train()`` from step 0 on the synthetic set,
    each timed by CUDA events, with the kernels' launches counted from 0 and
    the peak memory of the steps; ``literal`` forces the literal resample
    graph. ``moving`` (model -> tensors) must all change. Each step's
    metrics are the ones the trainer logged for it. Returns the run's record
    and the trainer (its loader stopped)."""
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.ops.fusion import prefer_literal_resample
    from stylex_tpu_torch.train.trainer import Trainer

    trainer = Trainer(name=f"smoke-{label}", base_dir=str(base), model_cfg=model_cfg,
                      train_cfg=tc, classifier_name="resnet", seed=0)
    graph = prefer_literal_resample if literal else contextlib.nullcontext
    logged = _logged_metrics(trainer)
    try:
        trainer.set_data_src(dataset_name="synthetic")
        trainer.init_stylex()
        model = trainer.state.model
        watched = [model.G.blocks[0].conv1.weight, model.D.fc.weight] + list(
            moving(model) if moving else [])
        before = [t.detach().clone() for t in watched]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        step_ms, ema_checks = [], {}
        for i in range(n_steps):
            with graph():
                ms, _ = _cuda_ms(trainer.train)
            step_ms.append(ms)
            if i == 2:  # the EMA reset copied G into GE
                ema_checks["reset_at_2"] = all(
                    torch.equal(a, b) for a, b in zip(model.GE.parameters(),
                                                       model.G.parameters()))
                ge2 = [p.detach().clone() for p in model.GE.parameters()]
            if i == 4:  # then moved by the EMA update
                ema_checks["update_at_4"] = not all(
                    torch.equal(a, b) for a, b in zip(model.GE.parameters(), ge2))
        trainer.flush()
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        trainer.close()
    rows = [dict(step=i, ms=ms, **logged[i]) for i, ms in enumerate(step_ms)]
    for r in rows:
        log(f"  {label} step {r['step']}: {r['ms']:.1f} ms " + " ".join(
            f"{k}={v:.5g}" for k, v in r.items() if k not in ("step", "ms")) + f" [{card}]")
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"{label} step {r['step']}: non-finite metrics {r}")
    moved = all(not torch.equal(a, b) for a, b in zip(before, watched))
    steady = step_ms[1:] or step_ms[:1]
    ms_step = statistics.median(steady)
    res = dict(steps=rows, launches=launches, peak_bytes=peak, ms_per_step=ms_step,
               images_per_s=tc.batch_size * tc.gradient_accumulate_every / (ms_step / 1e3),
               ema=ema_checks, moved=moved, graph="literal" if literal else "fused")
    log(f"  {label}: median {ms_step:.1f} ms/step over steps 1..{n_steps - 1} "
        f"(step 0 {rows[0]['ms']:.1f} ms, with the first save and evaluation), "
        f"{res['images_per_s']:.1f} images/s, peak {peak / 2**30:.3f} GiB, "
        f"launches {launches} [{card}]")
    if not moved:
        raise AssertionError(f"{label}: weights did not move")
    for name in ON_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: training did not launch kernel {name}")
    return res, trainer


def training_phase(card: str):
    """Phase 5; returns its record and the float32 fused-graph trainer after
    its 6 steps (Adam moments and ``pl_mean`` set), which phase 9 saves."""
    from stylex_tpu_torch.config import ModelConfig, TrainConfig

    base = Path(tempfile.mkdtemp(prefix="stylex_train_", dir=OUT_DIR))
    out, kept = {}, None
    try:
        for label, dtype, n_steps, literal in (("float32", "float32", 6, False),
                                                ("float32_literal", "float32", 6, True),
                                                ("bfloat16", "bfloat16", 2, False)):
            tc = TrainConfig(pl_start_step=0, pl_every=4, ema_start_step=0, ema_every=2,
                             save_every=1000, evaluate_every=1000, num_image_tiles=4,
                             compute_dtype=dtype)
            res, trainer = _train_run(card, base, label, ModelConfig(), tc, n_steps, literal)
            if label == "float32":  # kept for phase 9 on the host, off the device's memory
                _state_to(trainer.state, "cpu")
                kept = trainer
            del trainer
            out[label] = res
            ema_checks, rows = res["ema"], res["steps"]
            if dtype == "float32":
                gp = [r["gp"] for r in rows]
                if not (gp[0] > 0 and gp[4] > 0 and gp[1] == gp[2] == gp[3] == gp[5] == 0):
                    raise AssertionError(f"GP must run at steps 0 and 4 only: {gp}")
                pl = [r["pl_mean"] for r in rows]
                if not (pl[3] == -1.0 and pl[4] >= 0):
                    raise AssertionError(f"PL must first run at step 4: pl_mean {pl}")
                if not (ema_checks["reset_at_2"] and ema_checks["update_at_4"]):
                    raise AssertionError(f"EMA reset/update did not fire: {ema_checks}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out, kept


def _state_to(state, device) -> None:
    """Move a train state's model, Adam moments and ``pl_mean`` to
    ``device`` (values unchanged; Adam's step counts stay on the host)."""
    state.model.to(device)
    for opt in (state.g_opt, state.d_opt):
        for st in opt.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].to(device)
    state.pl_mean = state.pl_mean.to(device)


# ------------------------------------------------------------------ phase 6


TRAIN_TREES = ("encoder", "S", "G", "D")
# (input, weight, stride, padding): the trainable convs of phase 6's step
# where cuDNN's float32 weight gradient strays most (D over 4 fakes and 4
# reals, E and G over 4 images), a stride-2 one, LPIPS's frozen 5x5, the
# fused downsample's 5x5 stride-2 conv of D's first block (over its padded
# 67x67 map) and the fused upsample's coarse-grid conv of G's block 3
CONV_CASES = [((8, 64, 64, 64), (64, 64, 3, 3), 1, 1), ((4, 32, 64, 64), (32, 32, 3, 3), 1, 1),
              ((8, 128, 32, 32), (128, 128, 3, 3), 1, 1), ((4, 512, 8, 8), (512, 512, 3, 3), 1, 1),
              ((4, 256, 16, 16), (256, 256, 3, 3), 2, 1), ((8, 64, 32, 32), (128, 64, 1, 1), 2, 0),
              ((4, 64, 7, 7), (192, 64, 5, 5), 1, 2), ((8, 64, 67, 67), (64, 64, 5, 5), 2, 0),
              ((4, 128, 16, 16), (256, 128, 3, 3), 1, 1)]
GEMM_TOL = 1e-5  # of max |float64 result|; a direct float32 sum keeps ~1e-6


def _grad_errs(got, want):
    """Per tree: (max |got - want| / max|want|, elements beyond rtol
    CPU_RTOL + atol CPU_ATOL x max|want|, max|want|)."""
    out = {}
    for tree in TRAIN_TREES:
        keys = [k for k in want if k.startswith(tree + ".")]
        scale = max(float(want[k].abs().max()) for k in keys)
        worst, n_bad = 0.0, 0
        for k in keys:
            diff = (got[k].double() - want[k].double()).abs()
            n_bad += int((diff - (CPU_RTOL * want[k].double().abs() + CPU_ATOL * scale) > 0).sum())
            worst = max(worst, float(diff.max()) / scale)
        out[tree] = (worst, n_bad, scale)
    return out


def conv_precision():
    """Each conv of ``CONV_CASES`` alone: output, input gradient and weight
    gradient in float32 on the card, by the im2col path and by cuDNN,
    against float64 on the CPU (max |diff| / max |float64|). The im2col
    path must stay within ``GEMM_TOL``; cuDNN's errors are reported."""
    import torch.nn.functional as F

    from stylex_tpu_torch.device import set_float32_precision
    from stylex_tpu_torch.ops.conv import conv2d_gemm

    set_float32_precision()
    gen = torch.Generator().manual_seed(0)
    out = []
    for xs, ws, stride, pad in CONV_CASES:
        x = torch.randn(xs, generator=gen, dtype=torch.float64)
        w = torch.randn(ws, generator=gen, dtype=torch.float64) / np.sqrt(np.prod(ws[1:]))

        def run(fn, dev, dtype):
            xx = x.to(dev, dtype).requires_grad_(True)
            ww = w.to(dev, dtype).requires_grad_(True)
            y = fn(xx, ww, None, stride, pad)
            gy = torch.cos(torch.arange(y.numel(), dtype=torch.float64)).reshape(y.shape)
            grads = torch.autograd.grad(y, (xx, ww), gy.to(dev, dtype))
            return [t.detach().double().cpu() for t in (y, *grads)]

        ref = run(F.conv2d, "cpu", torch.float64)
        row = dict(x=list(xs), w=list(ws), stride=stride, padding=pad)
        for label, fn in (("gemm", conv2d_gemm), ("cudnn", F.conv2d)):
            got = run(fn, "cuda", torch.float32)
            row[label] = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
        out.append(row)
        log(f"  conv {xs} w{ws} stride {stride}: y/dx/dw error vs float64: im2col "
            + " ".join(f"{e:.3g}" for e in row["gemm"]) + ", cuDNN "
            + " ".join(f"{e:.3g}" for e in row["cudnn"]) + f" (im2col tol {GEMM_TOL})")
        if max(row["gemm"]) > GEMM_TOL:
            raise AssertionError(f"im2col conv {xs} w{ws}: error {max(row['gemm'])} > {GEMM_TOL}")
    return out


def train_card_vs_cpu_phase(cfg=None, tc=None, witness: bool = True):
    """One train step from the same weights, batch and draws: on the CPU in
    float64 (the witness: float64 copies of the float32 weights), on the CPU
    in float32, and on the card in float32 as the trainer runs it (trainable
    convolutions by im2col while autograd records, the rest in cuDNN).

    The step as trained has kinks (``smooth_kinks``): its losses are held
    (card against the CPU and the witness), its gradients reported, beside
    the CPU's own spread under a 1e-6 weight perturbation and the card with
    every convolution in cuDNN. The same step with its kinks smoothed is
    held in full: losses and gradients, float32 on the CPU and the card
    against the witness, the card against the CPU. ``cfg``/``tc`` default
    to the 64px config and batch 2 x 2 with GP, PL and augmentation on;
    without ``witness`` only the card and the CPU in float32 run."""
    from stylex_tpu_torch.config import ModelConfig, TrainConfig
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.device import map_tensors, set_float32_precision
    from stylex_tpu_torch.models import build_classifier, build_stylex
    from stylex_tpu_torch.models.lpips import init_lpips_params
    from stylex_tpu_torch.ops import conv as conv_ops
    from stylex_tpu_torch.testing.harness import PlainStep, smooth_kinks
    from stylex_tpu_torch.train import create_train_state, draw_step, make_train_step

    set_float32_precision()
    cfg = cfg or ModelConfig()
    tc = tc or TrainConfig(batch_size=2, gradient_accumulate_every=2, pl_start_step=-1,
                           pl_every=1, aug_prob=0.5)
    ds = SyntheticImageDataset(12, cfg.image_size, seed=2)
    imgs = (np.stack([ds[i] for i in range(12)]) * 255 + 0.5).astype(np.uint8)
    batch = {k: imgs[4 * j:4 * j + 4].reshape(2, 2, *imgs.shape[1:])
             for j, k in enumerate(("d_real", "d_enc", "g_imgs"))}
    sd = build_stylex(cfg, seed=3, device="cpu").state_dict()
    num_layers = int(np.log2(cfg.image_size)) - 1
    draws = draw_step(torch.Generator().manual_seed(5), cfg, tc, 2, num_layers, tc.aug_prob, 0)

    def run(dev, dtype, perturb: float = 0.0):
        model = build_stylex(cfg, device=dev)
        model.load_state_dict(sd)
        if perturb:
            gen = torch.Generator().manual_seed(11)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=gen).to(p.device))
        clf = build_classifier("resnet", cfg.image_size, seed=3, device=dev)
        clf.net.requires_grad_(False)
        if dtype == "float64":
            clf.to(torch.float64)
        step_tc = dataclasses.replace(tc, compute_dtype=dtype)
        state = create_train_state(model, cfg, step_tc)
        state.pl_mean = torch.tensor(0.5, device=state.device)
        state.g_opt = PlainStep([p for g in state.g_opt.param_groups for p in g["params"]],
                                1e-4)
        state.d_opt = PlainStep(list(model.D.parameters()), 1e-4)
        step = make_train_step(cfg, step_tc, clf.classify_images, init_lpips_params(device=dev))
        metrics = step(state, batch, map_tensors(draws, lambda t: t.to(dev)))
        names = [n for n, _ in model.named_parameters()]
        g_names = [n for n in names if n.startswith(("encoder.", "S.", "G."))]
        grads = dict(zip(g_names, state.g_opt.grads))
        grads.update(zip([n for n in names if n.startswith("D.")], state.d_opt.grads))
        return {k: float(v) for k, v in metrics.items()}, grads

    errs, faults = {}, []
    for smooth in (False, True):
        with smooth_kinks() if smooth else contextlib.nullcontext():
            runs = {"cpu_f32": run("cpu", "float32"), "card": run("cuda", "float32")}
            # (run, reference, losses held, gradients held)
            pairs = [("card", "cpu_f32", True, smooth)]
            if witness:
                runs["cpu_f64"] = run("cpu", "float64")
                pairs = [("cpu_f32", "cpu_f64", True, smooth), ("card", "cpu_f64", True, smooth),
                         *pairs]
            if witness and not smooth:
                runs["cpu_f32_perturbed"] = run("cpu", "float32", perturb=1e-6)
                conv_ops.GEMM_FLOAT32 = False
                try:
                    runs["card_cudnn_only"] = run("cuda", "float32")
                finally:
                    conv_ops.GEMM_FLOAT32 = True
                pairs += [("cpu_f32_perturbed", "cpu_f32", False, False),
                          ("card_cudnn_only", "cpu_f64", False, False),
                          ("card_cudnn_only", "cpu_f32", False, False)]
        graph = "smooth" if smooth else "as trained"
        for label, ref, hold_losses, hold_grads in pairs:
            (m, g), (m_ref, g_ref) = runs[label], runs[ref]
            name = f"{label}_vs_{ref}" + ("_smooth" if smooth else "")
            for k, want in m_ref.items():
                err = abs(m[k] - want)
                errs[f"{name}_{k}"] = err
                log(f"  [{graph}] {label} vs {ref} {k:9s}: {m[k]:.7g} vs {want:.7g}, abs err "
                    f"{err:.3g} (rtol {CPU_RTOL}, atol {CPU_ATOL})"
                    + ("" if hold_losses else " (reported)"))
                if hold_losses and err > CPU_ATOL + CPU_RTOL * abs(want):
                    faults.append(f"[{graph}] {label} vs {ref}: loss {k}")
            for tree, (worst, n_bad, scale) in _grad_errs(g, g_ref).items():
                errs[f"{name}_grad_{tree}_max_abs_err_over_max"] = worst
                errs[f"{name}_grad_{tree}_n_beyond"] = n_bad
                log(f"  [{graph}] {label} vs {ref} grad {tree:8s}: max |diff| / max|g| = "
                    f"{worst:.3g} (max|g| {scale:.4g}; {n_bad} elements beyond rtol {CPU_RTOL}, "
                    f"atol {CPU_ATOL} x max|g|)" + ("" if hold_grads else " (reported)"))
                if hold_grads and n_bad:
                    faults.append(f"[{graph}] {label} vs {ref}: grad {tree}")
    if faults:
        raise AssertionError(f"train step: runs disagree: {faults}")
    return errs


# ------------------------------------------------------------------ phase 7


def options_phase(card: str):
    """Training with attention, the no_const stem, a quantize layer and the
    contrastive regulariser by the scan step, at full width; the same
    configuration's step on the card against the CPU; a debug encoder."""
    from stylex_tpu_torch.config import ModelConfig, TrainConfig
    from stylex_tpu_torch.models import build_stylex

    cfg = ModelConfig(attn_layers=(1, 2), no_const=True, fq_layers=(2,))
    tc = TrainConfig(cl_reg=True, fused_microbatches=False, pl_start_step=0, pl_every=2,
                     ema_start_step=0, ema_every=2, save_every=1000, evaluate_every=1000,
                     num_image_tiles=4)
    base = Path(tempfile.mkdtemp(prefix="stylex_options_", dir=OUT_DIR))
    try:
        res, _ = _train_run(card, base, "options", cfg, tc, 3, moving=lambda m: [
            m.D.quantize_blocks[1].codebook, m.encoder.quantize_blocks[1].codebook,
            m.G.to_initial_block.weight, m.G.attns[3][0].fn.fn.to_q.weight,
            m.D.attn_blocks[0][0].fn.fn.to_q.weight])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    rows = res["steps"]
    if not (rows[0]["gp"] > 0 and rows[2]["pl_mean"] >= 0
            and all(r["cr_loss"] > 0 and r["q_loss"] > 0 for r in rows)):
        raise AssertionError(f"options: GP, PL, the contrastive or quantize loss missing: {rows}")

    log("  options step, batch 2 x 2, card against CPU (float32, TF32 off)")
    step_tc = TrainConfig(batch_size=2, gradient_accumulate_every=2, pl_start_step=-1,
                          pl_every=1, aug_prob=0.5, cl_reg=True, fused_microbatches=False)
    res["card_vs_cpu"] = train_card_vs_cpu_phase(cfg, step_tc, witness=False)

    enc_cfg = ModelConfig(encoder_class="PhillipEncoder64")
    encoder = build_stylex(enc_cfg, seed=0).encoder
    x = torch.rand(4, 3, 64, 64, generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        enc = encoder(x)
    log(f"  PhillipEncoder64 on the card: {tuple(enc.shape)}, max |e| "
        f"{float(enc.abs().max()):.4g} [{card}]")
    if enc.shape != (4, 512) or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"PhillipEncoder64: {tuple(enc.shape)} or non-finite")
    res["debug_encoder_shape"] = list(enc.shape)
    return res


# ------------------------------------------------------------------ phase 8


def _sync_s(fn):
    """Host seconds of ``fn()`` between two device synchronisations, and
    its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


class _Timed:
    """Replaces ``module.name`` by a wrapper that adds each call's host
    seconds (device synchronised) to ``seconds``; restored on exit."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        self.inner = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            t, out = _sync_s(lambda: self.inner(*args, **kwargs))
            self.seconds.append(t)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def evaluation_phase(card: str, f32_run):
    """Phase 8: InceptionV3 features, the counterfactual protocol, training
    with FID and the evaluation CLIs, float32 with TF32 off. The Inception
    weights are the port's seeded init, saved as a torchvision-layout state
    dict and read through ``STYLEX_TPU_INCEPTION``; (c) unsets it, so the
    trainer takes its default extractor, the seeded AlexNet. Returns the
    record and (b)'s records, picks and ``fid_results.csv`` rows, which
    phase 9 (e) holds the counterfactual runner against."""
    import os

    from stylex_tpu_torch.device import set_float32_precision
    from stylex_tpu_torch.models.inception import ENV, build_inception

    set_float32_precision()
    base = Path(tempfile.mkdtemp(prefix="stylex_eval_", dir=OUT_DIR))
    weights = base / "inception_seeded.pt"
    torch.save(build_inception(seed=0, device="cpu").state_dict(), weights)
    saved = os.environ.get(ENV)
    os.environ[ENV] = str(weights)
    out = {}
    try:
        out["inception"] = _eval_inception(card, f32_run)
        out["counterfactual"], cf_run = _eval_counterfactual(card, f32_run, base)
        del os.environ[ENV]
        out["training"] = _eval_training(card, base)
        out["clis"] = _eval_clis(card, base, f32_run[1])
    finally:
        os.environ.pop(ENV, None)
        if saved is not None:
            os.environ[ENV] = saved
        shutil.rmtree(base, ignore_errors=True)
    return out, cf_run


def _eval_inception(card: str, f32_run):
    """(a) pool3 features of 4 generated 64px images, card against CPU;
    images/s of the feature function at batch 64."""
    from stylex_tpu_torch.eval.counterfactual import create_counterfactual_dataset
    from stylex_tpu_torch.models.inception import default_pool3_features

    (model, _), records = f32_run
    images = create_counterfactual_dataset(model, None, records, [], 0)
    x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))
    card_fn, cpu_fn = default_pool3_features("cuda"), default_pool3_features("cpu")
    got, want = card_fn(x).cpu().numpy(), cpu_fn(x).numpy()
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    log(f"  (a) Inception pool3 of {tuple(x.shape)} generated images: card vs CPU max abs err "
        f"{err:.4g} (tol 1e-3 x max|f| = {1e-3 * scale:.4g}) [{card}]")
    if got.shape != (4, 2048) or not np.isfinite(got).all() or err > 1e-3 * scale:
        raise AssertionError(f"Inception features: shape {got.shape}, error {err} > {1e-3 * scale}")
    batch = x.repeat(16, 1, 1, 1).cuda()
    ms = time_ms(card_fn, batch, reps=10, loops=3)
    log(f"  (a) pool3_features_fn at batch 64 (64px -> 299): {ms:.3f} ms per batch = "
        f"{64 / ms * 1e3:.1f} images/s [{card}]")
    return dict(max_abs_err=err, max_abs_f=scale, batch64_ms=ms, images_per_s=64 / ms * 1e3)


def _eval_counterfactual(card: str, f32_run, base: Path):
    """(b) The filtered greedy search (D on), the counterfactual images for
    k = 1..3 (card against CPU) and ``fid_topk`` with k = 3, with the kernel
    launches of the whole step counted from 0."""
    import csv

    from stylex_tpu_torch.eval import counterfactual as cf
    from stylex_tpu_torch.models import build_stylex
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches

    (model, clf), r32 = f32_run
    # Random weights move MobileNetV2's logits by ~1e-5, where a trained
    # classifier's effects are O(1); the filter probes D only for images
    # whose effect exceeds 0.2. Rescaled so that the first candidate's mean
    # effect is 1, the records make the search probe D as it would there.
    first = np.maximum(0.0, r32.style_change[..., 0]).mean(axis=0).max()
    records = dataclasses.replace(r32, style_change=r32.style_change / first)
    reset_launches()
    t_search, (picks, rejected) = _sync_s(lambda: cf.find_significant_styles_filtered(
        records, 3, 0, model=model, classifier_fn=clf.classify_images))
    log(f"  (b) find_significant_styles_filtered (D on): picks {picks}, rejected {rejected}, "
        f"{t_search:.3f} s [{card}]")
    if not picks:
        raise AssertionError("the filtered search picked nothing")

    cpu_model = build_stylex(model.cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cf_errs, cf_s = [], []
    for k in (1, 2, 3):
        t, got = _sync_s(lambda: cf.create_counterfactual_dataset(model, None, records, picks, k))
        want = cf.create_counterfactual_dataset(cpu_model, None, records, picks, k)
        cf_errs.append(float(np.abs(got - want).max()))
        cf_s.append(t)
        size = model.cfg.image_size
        if got.shape != (N_IMAGES, size, size, 3) or cf_errs[-1] > 1e-4:
            raise AssertionError(f"counterfactuals k={k}: shape {got.shape}, card vs CPU "
                                 f"{cf_errs[-1]} > 1e-4")
    log(f"  (b) create_counterfactual_dataset k=1..3: card vs CPU max abs err "
        + ", ".join(f"{e:.3g}" for e in cf_errs) + " (tol 1e-4), card "
        + ", ".join(f"{t:.4f}" for t in cf_s) + f" s [{card}]")

    csv_path = base / "fid_results.csv"
    with _Timed(cf, "frechet_distance") as fd, _Timed(cf, "compute_feature_stats") as st:
        t_fid, fids = _sync_s(lambda: cf.fid_topk(model, None, records, picks, k=3,
                                                  csv_path=str(csv_path)))
    launches = dict(LAUNCHES)
    rows = list(csv.reader(open(csv_path)))
    gen_s = t_fid - sum(fd.seconds) - sum(st.seconds)
    log(f"  (b) fid_topk k=3 (Inception): FIDs {fids}, {t_fid:.3f} s = frechet_distance "
        f"{sum(fd.seconds):.3f} s over {len(fd.seconds)} calls (host sqrtm of 2048x2048; "
        f"{', '.join(f'{t:.3f}' for t in fd.seconds)}) + feature stats {sum(st.seconds):.3f} s "
        f"+ generation {gen_s:.3f} s [{card}]")
    log(f"  (b) launches over the step: {launches} [{card}]")
    if len(fids) != 4 or not all(np.isfinite(fids)):
        raise AssertionError(f"fid_topk: {fids}")
    if [r[0] for r in rows] != ["k", "generated", "1", "2", "3"]:
        raise AssertionError(f"fid_results.csv rows {rows}")
    for name in ON_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"the counterfactual protocol did not launch kernel {name}")
    result = dict(picks=picks, rejected=rejected, effect_rescale=float(1.0 / first),
                  search_s=t_search, counterfactual_max_abs_err=cf_errs, counterfactual_s=cf_s,
                  fids=fids, fid_topk_s=t_fid, frechet_s=fd.seconds, feature_stats_s=st.seconds,
                  generation_s=gen_s, launches=launches)
    return result, dict(records=records, picks=picks, rows=rows)


def _eval_training(card: str, base: Path):
    """(c) ``Trainer.train()`` at the CLI defaults on the synthetic set with
    FID every 2 steps over 256 images: steps 0, 1, 2 (never at step 0, so
    one FID, after step 2); a second FID that must read the cached real
    statistics and no real image; an 8-frame interpolation GIF. Saves the
    checkpoint that (d) reads."""
    from PIL import Image

    from stylex_tpu_torch.config import TrainConfig
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.train.trainer import Trainer

    class NoRealImages:
        def __next__(self):
            raise AssertionError("a cached FID read a real image")

    tc = TrainConfig(calculate_fid_every=2, calculate_fid_num_images=256, save_every=1000,
                     evaluate_every=1000, num_image_tiles=4)
    trainer = Trainer(name="smoke-eval", base_dir=str(base), train_cfg=tc,
                      classifier_name="resnet", seed=0)
    try:
        trainer.set_data_src(dataset_name="synthetic")
        reset_launches()
        step_ms = []
        for _ in range(3):
            ms, metrics = _cuda_ms(trainer.train)
            step_ms.append(ms)
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"training with FID: non-finite metrics {metrics}")
        launches = dict(LAUNCHES)
        lines = (base / "results" / "smoke-eval" / "fid_scores.txt").read_text().splitlines()
        log(f"  (c) 3 steps at the CLI defaults with FID every 2 over 256 images: "
            f"{', '.join(f'{m:.1f}' for m in step_ms)} ms (step 2 with the FID); "
            f"fid_scores.txt {lines}; launches {launches} [{card}]")
        if len(lines) != 1 or lines[0].split(",")[0] != "2" or not np.isfinite(
                float(lines[0].split(",")[1])):
            raise AssertionError(f"fid_scores.txt: {lines}")
        real, trainer.loader.sample_loader = trainer.loader.sample_loader, NoRealImages()
        try:
            t_cached, fid2 = _sync_s(lambda: trainer.calculate_fid(256 // tc.batch_size))
        finally:
            trainer.loader.sample_loader = real
        t_gif, gif = _sync_s(lambda: trainer.generate_interpolation(num_steps=8))
        frames = Image.open(gif).n_frames
        log(f"  (c) second calculate_fid from real_stats.npz: {fid2:.6g} in {t_cached:.3f} s; "
            f"interpolation GIF {frames} frames in {t_gif:.3f} s [{card}]")
        if not np.isfinite(fid2) or frames != 8:
            raise AssertionError(f"cached FID {fid2}, GIF frames {frames}")
        for name in ON_PATH:
            if launches[name] <= 0:
                raise AssertionError(f"training with FID did not launch kernel {name}")
        trainer.save(0)
    finally:
        trainer.close()
    return dict(step_ms=step_ms, fid_line=lines[0], cached_fid=fid2, cached_fid_s=t_cached,
                gif_frames=frames, gif_s=t_gif, launches=launches)


def _eval_clis(card: str, base: Path, records):
    """(d) ``replay_results`` on phase 3's records with (c)'s checkpoint,
    and one user study at the default 512-pixel panels."""
    from PIL import Image

    from stylex_tpu_torch import replay_results, user_study
    from stylex_tpu_torch.attfind import records_file_name, save_records
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches

    h5 = base / records_file_name()  # .npz where h5py is not installed
    save_records(records, str(h5))
    model_args = ["--name", "smoke-eval", "--base-dir", str(base), "--classifier-name", "resnet"]
    reset_launches()
    replay_out = base / "replay"
    t_replay, _ = _sync_s(lambda: replay_results.main(
        ["--records", str(h5), "--out", str(replay_out), "--visualize-top", "2",
         "--max-images", "4", *model_args]))
    top = json.loads((replay_out / "top_styles.json").read_text())
    panels = sorted(p.name for p in replay_out.glob("style_*.png"))
    study_out = base / "user_study"
    t_study, _ = _sync_s(lambda: user_study.main(
        ["--records", str(h5), "--out", str(study_out), "--num-studies", "1", *model_args]))
    launches = dict(LAUNCHES)
    gifs = sorted(study_out.glob("class_study_*.gif"))
    gif = Image.open(gifs[0]) if gifs else None
    # the base and counterfactual frames, 750 ms each; PIL stores equal
    # frames as one frame of their summed duration
    frames_ms = []
    for i in range(gif.n_frames if gif else 0):
        gif.seek(i)
        frames_ms.append(gif.info["duration"])
    key = (study_out / "info_of_images.txt").read_text()
    log(f"  (d) replay_results: ranked {top['ranked']}, panels {panels}, {t_replay:.3f} s; "
        f"user study: {[g.name for g in gifs]} {gif.size if gif else None}, frame durations "
        f"{frames_ms} ms, {t_study:.3f} s; launches {launches} [{card}]")
    want = {f"style_{d}_{s}_by_distance.png" for d, s in top["ranked"][:2]}
    if not want or not want <= set(panels):
        raise AssertionError(f"replay panels {panels}, expected {sorted(want)}")
    if len(gifs) != 1 or sum(frames_ms) != 1500 or gif.size != (1030, 1030) or not key.startswith(
            "Odd transformation in "):
        raise AssertionError(f"user study: {gifs}, {gif and gif.size}, {frames_ms}, {key[:40]!r}")
    if launches["upsample2x_bilinear"] <= 0:
        raise AssertionError("the evaluation CLIs did not launch the upsample kernel")
    return dict(replay_s=t_replay, ranked=top["ranked"], panels=panels, user_study_s=t_study,
                user_study_frames_ms=frames_ms, launches=launches)


# ------------------------------------------------------------------ phase 9


def weights_phase(card: str, src, f32_run, cf_run):
    """Phase 9: model files in and out at full width, float32 with TF32 off
    unless stated. (a) phase 5's float32 trainer saved as the JAX package's
    ``model_1.ckpt`` and loaded in full by a fresh trainer, equal bit for
    bit, then one train step from each on the same batch and draws; (b) an
    inference load in bfloat16 and ``run_attfind --name`` on it against an
    in-process sweep; (c) MobileNetV2, LPIPS and InceptionV3 ``.msgpack``
    trees written by ``ingest`` and read back against the ``.pt`` route;
    (d) classifier pretraining through ``train_classifier``; (e) the
    counterfactual runner on phase 8's records against phase 8's
    ``fid_topk`` rows."""
    from stylex_tpu_torch.device import set_float32_precision

    set_float32_precision()
    _state_to(src.state, "cuda")
    base = Path(tempfile.mkdtemp(prefix="stylex_weights_", dir=OUT_DIR))
    out = {}
    try:
        out["full_load"], fresh = _weights_full_load(card, src, base)
        try:
            # before any step moves the source away from the file
            out["inference_load"] = _weights_inference_load(card, src, base,
                                                            out["full_load"]["device_bytes"])
            out["full_load"].update(_weights_resumed_step(card, src, fresh))
        finally:
            fresh.close()
        out["trees"] = _weights_trees(card, base, f32_run)
        out["classifier_training"] = _weights_classifier_training(card, base)
        out["counterfactual_runner"] = _weights_counterfactual_runner(card, base, f32_run, cf_run)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def _adam_moments(state):
    """parameter name -> (exp_avg, exp_avg_sq, step, lr, betas, eps), copied,
    of each parameter that has Adam state."""
    names = {id(p): k for k, p in state.model.named_parameters()}
    out = {}
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p)
                if st:
                    out[names[id(p)]] = (st["exp_avg"].detach().clone(),
                                         st["exp_avg_sq"].detach().clone(), float(st["step"]),
                                         group["lr"], group["betas"], group["eps"])
    return out


def _state_tensors(state):
    """name -> tensor of the model's parameters and buffers and of each
    parameter's Adam moments and count."""
    out = dict(state.model.state_dict())
    for k, (m1, v1, step, *_) in _adam_moments(state).items():
        out.update({f"adam.{k}.exp_avg": m1, f"adam.{k}.exp_avg_sq": v1,
                    f"adam.{k}.step": torch.tensor(step)})
    return out


def _weights_full_load(card: str, src, base: Path):
    """(a) Save, then a full load into a fresh trainer: every tensor
    equal."""
    from stylex_tpu_torch.train.trainer import Trainer
    from stylex_tpu_torch.utils.checkpoint import save_jax_checkpoint

    models = base / "models"
    t_save, path = _sync_s(lambda: save_jax_checkpoint(str(models), "smoke9", 1, src.state))
    (models / "smoke9" / ".config.json").write_text(src.model_cfg.to_json())
    size = Path(path).stat().st_size
    log(f"  (a) save_jax_checkpoint of phase 5's float32 trainer (step {src.state.step}): "
        f"{size} bytes = {size / 1e9:.4f} GB in {t_save:.3f} s [{card}]")
    fresh = Trainer(name="smoke9", base_dir=str(base), train_cfg=src.train_cfg,
                    classifier_name="resnet", seed=1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t_load, _ = _sync_s(lambda: fresh.load(1))
    full_bytes = torch.cuda.memory_allocated() - before
    want, got = _state_tensors(src.state), _state_tensors(fresh.state)
    unequal = sorted(k for k in want if k not in got or not torch.equal(got[k], want[k]))
    unequal += sorted(k for k in got if k not in want)
    same_counters = (fresh.state.step == src.state.step
                     and torch.equal(fresh.state.pl_mean, src.state.pl_mean))
    log(f"  (a) Trainer.load(1) in full: {t_load:.3f} s, device memory +{full_bytes} bytes "
        f"({full_bytes / 2**20:.1f} MiB); {len(want)} tensors (parameters, buffers, Adam "
        f"moments and counts), {len(unequal)} unequal; step {fresh.state.step}, pl_mean "
        f"{float(fresh.state.pl_mean):.6g} [{card}]")
    if unequal or not same_counters or float(src.state.pl_mean) < 0:
        raise AssertionError(f"full load: unequal {unequal[:8]}, counters {same_counters}, "
                             f"pl_mean {float(src.state.pl_mean)}")
    return dict(bytes=size, save_s=t_save, load_s=t_load, device_bytes=full_bytes,
                tensors=len(want)), fresh


def _weights_resumed_step(card: str, src, fresh):
    """(a) One train step from the source and from the loaded trainer on the
    same batch and draws: losses within phase 6's rtol, and the gradients,
    read from Adam's first moments (m_new = b1 m_old + (1 - b1) g), within
    phase 6's 1e-4 x max|g| per tree. Each parameter update of the loaded
    trainer is then Adam's from its own moments, learning rate and count
    (1e-4 relative plus two float32 ulps of |p|): the restored state is the
    one the step used. The parameters' own difference is reported: Adam
    divides by sqrt(v), which magnifies rounding where v is small."""
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.train.steps import draw_step

    fresh.set_data_src(dataset_name="synthetic")
    batch = next(fresh.loader)
    tc, cfg = src.train_cfg, src.model_cfg
    draws = draw_step(torch.Generator(device="cuda").manual_seed(9), cfg, tc, tc.batch_size,
                      src.state.model.num_layers, src.aug_prob or 0.0, src.state.step)
    states = {"source": src.state, "loaded": fresh.state}
    before = {label: ({k: p.detach().clone() for k, p in st.model.named_parameters()},
                      _adam_moments(st)) for label, st in states.items()}
    reset_launches()
    metrics = {label: {k: float(v) for k, v in trainer._step_fn(trainer.state, batch,
                                                                draws).items()}
               for label, trainer in (("source", src), ("loaded", fresh))}
    launches = dict(LAUNCHES)
    m_src, m_new = metrics["source"], metrics["loaded"]
    loss_err = max(abs(m_new[k] - m_src[k]) / max(abs(m_src[k]), 1e-30) for k in m_src)

    grads, after = {}, {}
    for label, st in states.items():
        params_before, adam_before = before[label]
        adam_after = _adam_moments(st)
        grads[label], after[label] = {}, {}
        for key, (m1, v1, step, lr, (b1, b2), eps) in adam_after.items():
            grads[label][key] = (m1 - b1 * adam_before[key][0]) / (1 - b1)
            after[label][key] = (m1, v1, step, lr, b1, b2, eps)
    grad_err, formula_err = 0.0, 0.0
    for tree in ("encoder", "S", "G", "D"):
        keys = [k for k in grads["source"] if k.startswith(tree + ".")]
        scale = max(float(grads["source"][k].abs().max()) for k in keys)
        for k in keys:
            grad_err = max(grad_err, float((grads["loaded"][k] - grads["source"][k]).abs().max())
                           / max(scale, 1e-30))
    loaded_p = dict(fresh.state.model.named_parameters())
    for k, (m1, v1, step, lr, b1, b2, eps) in after["loaded"].items():
        p0 = before["loaded"][0][k].double()
        want = -lr / (1 - b1 ** step) * m1.double() / (
            (v1.double() / (1 - b2 ** step)).sqrt() + eps)
        err = (loaded_p[k].detach().double() - p0 - want).abs()
        bound = 1e-4 * want.abs() + 2.0 ** -22 * p0.abs() + 1e-12
        formula_err = max(formula_err, float((err / bound).max()))
    src_p = dict(src.state.model.named_parameters())
    param_err, bitwise = 0.0, True
    for tree in ("encoder", "S", "G", "D"):
        keys = [k for k in src_p if k.startswith(tree + ".")]
        moved = max(float((src_p[k].detach() - before["source"][0][k]).abs().max())
                    for k in keys)
        for k in keys:
            d = float((loaded_p[k].detach() - src_p[k].detach()).abs().max())
            bitwise &= d == 0.0
            param_err = max(param_err, d / max(moved, 1e-30))
    log(f"  (a) one step from each (step {src.state.step - 1}): metrics {m_src}; max rel "
        f"metric diff {loss_err:.3g} (tol {CPU_RTOL}); gradients from the first moments: "
        f"max |diff| {grad_err:.3g} x the tree's max|g| (tol {CPU_ATOL}); the loaded "
        f"trainer's updates against Adam's from its moments: {formula_err:.3g} of the bound "
        f"(must be <= 1); parameters: max |diff| {param_err:.3g} x the tree's largest update, "
        f"bit for bit {bitwise}; launches {launches} [{card}]")
    if loss_err > CPU_RTOL or grad_err > CPU_ATOL or formula_err > 1.0:
        raise AssertionError(f"steps from the source and the loaded trainer disagree: metrics "
                             f"{loss_err}, gradients {grad_err}, Adam updates {formula_err}")
    for name in ON_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"the resumed train step did not launch kernel {name}")
    return dict(step_metrics=m_src, step_metric_rel_err=loss_err, step_grad_rel_err=grad_err,
                step_adam_formula_err=formula_err, step_param_rel_err=param_err,
                step_bitwise=bitwise, launches=launches)


def _weights_inference_load(card: str, src, base: Path, full_bytes: int):
    """(b) ``load(inference=True, ship_ema=False, param_dtype=bfloat16)``:
    its device memory, ``train()`` refused; ``run_attfind --name`` on 4
    synthetic images against ``attfind_extraction`` on the source's live
    nets cast to bfloat16, the same images, noise and settings."""
    import copy

    from stylex_tpu_torch import run_attfind
    from stylex_tpu_torch.attfind import attfind_extraction, load_records, records_file_name
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.ops.latents import image_noise
    from stylex_tpu_torch.train.trainer import Trainer

    inf = Trainer(name="smoke9", base_dir=str(base), train_cfg=src.train_cfg,
                  classifier_name="resnet", seed=1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t_load, _ = _sync_s(lambda: inf.load(1, inference=True, ship_ema=False,
                                         param_dtype=torch.bfloat16))
    inf_bytes = torch.cuda.memory_allocated() - before
    inf.set_data_src(dataset_name="synthetic")
    try:
        inf.train()
        refused = False
    except RuntimeError:
        refused = True
    finally:
        inf.close()
    del inf
    log(f"  (b) Trainer.load(1, inference=True, ship_ema=False, param_dtype=bfloat16): "
        f"{t_load:.3f} s, device memory +{inf_bytes} bytes ({inf_bytes / 2**20:.1f} MiB) "
        f"against the full load's +{full_bytes} ({full_bytes / 2**20:.1f} MiB): "
        f"{inf_bytes / full_bytes:.3f}x; train() refused: {refused} [{card}]")
    if not refused:
        raise AssertionError("train() ran after an inference load")

    out = base / "attfind"
    reset_launches()
    t_cli, _ = _sync_s(lambda: run_attfind.main(
        ["--name", "smoke9", "--base-dir", str(base), "--load-from", "1", "--dtype", "bfloat16",
         "--coord-batch", str(COORD_BATCH), "--dataset-name", "synthetic", "--num-images",
         str(N_IMAGES), "--classifier-name", "resnet", "--results-folder", str(out)]))
    launches = dict(LAUNCHES)
    got = load_records(str(out / records_file_name()))
    cfg = src.model_cfg
    model = copy.deepcopy(src.state.model).to(torch.bfloat16).eval()
    clf = copy.deepcopy(src.classifier).to(torch.bfloat16)
    ds = SyntheticImageDataset(N_IMAGES, cfg.image_size)
    images = np.stack([ds[i] for i in range(N_IMAGES)])
    noise = image_noise(torch.Generator().manual_seed(42), 1, cfg.image_size).numpy()
    want = attfind_extraction(model, clf.classify_images, images, noise, coord_batch=COORD_BATCH,
                              compute_dtype=torch.bfloat16, progress=False)
    del model, clf
    fields = ("style_change", "latents", "base_prob", "minima", "maxima", "style_coordinates",
              "original_images", "noise", "discriminator")
    diffs = {f: float(np.abs(getattr(got, f) - getattr(want, f)).max()) for f in fields}
    log(f"  (b) run_attfind --name --load-from 1 --dtype bfloat16 --coord-batch {COORD_BATCH} "
        f"({N_IMAGES} synthetic images, ResNet-18): {t_cli:.3f} s; records against the "
        f"in-process sweep, max |diff| {diffs} (must be 0); launches {launches} [{card}]")
    if any(d != 0.0 for d in diffs.values()):
        raise AssertionError(f"run_attfind on the loaded checkpoint differs: {diffs}")
    for name in ON_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"run_attfind on the loaded checkpoint did not launch {name}")
    return dict(load_s=t_load, device_bytes=inf_bytes, ratio_to_full=inf_bytes / full_bytes,
                train_refused=refused, run_attfind_s=t_cli, record_max_abs_diff=diffs,
                launches=launches)


def _lpips_package_state_dict(params):
    """The port's LPIPS params in ``lpips.LPIPS(net='alex')``'s key layout
    (the AlexNet convs at slice indices 0, 3, 6, 8, 10; the taps as
    (1, C, 1, 1) 1x1 conv weights)."""
    sd = {}
    for i, idx in enumerate((0, 3, 6, 8, 10)):
        sd[f"net.slice{i + 1}.{idx}.weight"] = params[f"conv{i}"]["weight"].cpu()
        sd[f"net.slice{i + 1}.{idx}.bias"] = params[f"conv{i}"]["bias"].cpu()
        sd[f"lin{i}.model.1.weight"] = params[f"lin{i}"].cpu().reshape(1, -1, 1, 1)
    return sd


def _weights_trees(card: str, base: Path, f32_run):
    """(c) ``.msgpack`` trees of the seeded MobileNetV2, LPIPS and
    InceptionV3 written by the port's ``ingest`` and read back by
    ``build_classifier``, ``load_lpips_params`` and ``STYLEX_TPU_INCEPTION``:
    outputs equal to the ``.pt`` route's, bit for bit."""
    import os

    from stylex_tpu_torch import ingest
    from stylex_tpu_torch.eval.counterfactual import create_counterfactual_dataset
    from stylex_tpu_torch.models import build_classifier
    from stylex_tpu_torch.models import lpips as tlpips
    from stylex_tpu_torch.models.inception import ENV, build_inception, default_pool3_features

    (model, _), records = f32_run
    x = torch.from_numpy(np.ascontiguousarray(
        create_counterfactual_dataset(model, None, records, [], 0).transpose(0, 3, 1, 2))).cuda()
    res = {}
    pt, mp = base / "mobilenet.pt", base / "mobilenet.msgpack"
    torch.save(build_classifier("mobilenet", 64, seed=0).net.state_dict(), pt)
    ingest.ingest_classifier(str(pt), "mobilenet", str(mp))
    want = build_classifier("mobilenet", 64, checkpoint_path=str(pt)).classify_images(x)
    got = build_classifier("mobilenet", 64, checkpoint_path=str(mp)).classify_images(x)
    res["mobilenet_equal"] = bool(torch.equal(got, want))

    pt, mp = base / "lpips.pt", base / "lpips.msgpack"
    torch.save(_lpips_package_state_dict(tlpips.init_lpips_params(seed=3, device="cpu")), pt)
    ingest.ingest_lpips(str(pt), str(mp))
    y = x.flip(0)
    want = tlpips.lpips_distance(tlpips.load_lpips_params(str(pt), "cuda"), x, y)
    got = tlpips.lpips_distance(tlpips.load_lpips_params(str(mp), "cuda"), x, y)
    res["lpips_equal"] = bool(torch.equal(got, want))

    pt, mp = base / "inception.pt", base / "inception.msgpack"
    torch.save(build_inception(seed=0, device="cpu").state_dict(), pt)
    ingest.ingest_inception(str(pt), str(mp))
    saved = os.environ.get(ENV)
    try:
        feats = {}
        for label, path in (("pt", pt), ("msgpack", mp)):
            os.environ[ENV] = str(path)
            feats[label] = default_pool3_features("cuda")(x)
    finally:
        os.environ.pop(ENV, None)
        if saved is not None:
            os.environ[ENV] = saved
    res["inception_equal"] = bool(torch.equal(feats["pt"], feats["msgpack"]))
    res["bytes"] = {p.name: p.stat().st_size for p in base.glob("*.msgpack")}
    log(f"  (c) .msgpack trees through ingest, read back against the .pt route on "
        f"{tuple(x.shape)} images: MobileNetV2 logits equal {res['mobilenet_equal']}, LPIPS "
        f"distances equal {res['lpips_equal']}, Inception pool3 equal {res['inception_equal']}; "
        f"sizes {res['bytes']} [{card}]")
    if not (res["mobilenet_equal"] and res["lpips_equal"] and res["inception_equal"]):
        raise AssertionError(f"a .msgpack tree reads differently from its .pt: {res}")
    return res


def _weights_classifier_training(card: str, base: Path):
    """(d) ``train_classifier --dataset synthetic``: MobileNetV2 at 64 px for
    one epoch, ResNet-18 at 224 px progressively for three; finite losses,
    the results JSON, and the saved ``classifier.msgpack`` reproducing the
    trainer's validation logits through ``build_classifier``."""
    from stylex_tpu_torch import train_classifier
    from stylex_tpu_torch.models import build_classifier
    from stylex_tpu_torch.models.classifiers import imagenet_normalize
    from stylex_tpu_torch.train.classifier_training import ClassifierTrainer

    res = {}
    for label, argv in (("mobilenet", ["--model", "mobilenet", "--image-size", "64",
                                       "--epochs", "1"]),
                        ("resnet", ["--model", "resnet", "--progressive", "--image-size", "224",
                                    "--epochs", "3"])):
        out = base / f"clf_{label}"
        args = train_classifier.parse_args(
            ["--dataset", "synthetic", "--saved-models-dir", str(out), "--results-dir", str(out),
             "--tensorboard-dir", str(out / "tb"), *argv])
        with _Timed(ClassifierTrainer, "train_epoch") as epochs:
            t, (trainer, results) = _sync_s(lambda: train_classifier.train(args))
        losses = [results[f"epoch_{e}"]["loss"] for e in range(args.epochs)]
        _, valid, _ = train_classifier.datasets(args)
        batch = next(train_classifier.labeled_batches(valid, len(valid), shuffle=False))[0]
        want = trainer.logits(batch)
        clf = build_classifier(args.model, args.image_size,
                               checkpoint_path=str(out / "classifier.msgpack"))
        x = torch.from_numpy(batch).cuda().permute(0, 3, 1, 2).float() / 255.0
        with torch.no_grad():
            got = clf.net(imagenet_normalize(x))
        err = float((got - want).abs().max())
        n_train = 64  # the synthetic training set
        ips = [n_train / s for s in epochs.seconds]
        log(f"  (d) train_classifier {' '.join(argv)}: {t:.3f} s; losses {losses}; results "
            f"{ {k: results[k] for k in ('test_accuracy', 'best_val_accuracy')} }; training "
            f"epochs {', '.join(f'{s:.4f}' for s in epochs.seconds)} s = "
            f"{', '.join(f'{v:.1f}' for v in ips)} images/s; classifier.msgpack through "
            f"build_classifier against the trainer's validation logits: max |diff| {err:.3g} "
            f"[{card}]")
        if not all(np.isfinite(losses)) or not (out / "classifier.msgpack.json").exists():
            raise AssertionError(f"{label}: losses {losses} or no results JSON")
        if err > 1e-5 * max(float(want.abs().max()), 1.0):
            raise AssertionError(f"{label}: the saved classifier gives other logits ({err})")
        res[label] = dict(seconds=t, losses=losses, epoch_s=epochs.seconds, images_per_s=ips,
                          logits_max_abs_err=err, **{k: results[k] for k in (
                              "test_accuracy", "best_val_accuracy")})
    return res


def _weights_counterfactual_runner(card: str, base: Path, f32_run, cf_run):
    """(e) ``run_counterfactual`` with phase 3's float32 model saved as a JAX
    ``.ckpt``, phase 8's records and picks, and the seeded Inception
    weights: ``fid_results.csv`` equal to phase 8's rows."""
    import csv
    import os

    from stylex_tpu_torch import run_counterfactual
    from stylex_tpu_torch.attfind import save_records
    from stylex_tpu_torch.config import TrainConfig
    from stylex_tpu_torch.models.inception import ENV, build_inception
    from stylex_tpu_torch.train.state import create_train_state
    from stylex_tpu_torch.utils.checkpoint import save_jax_checkpoint

    (model, _), _ = f32_run
    att = base / "counterfactual"
    att.mkdir()
    save_records(cf_run["records"], str(att / "style_change_records.npz"))
    (att / "top_styles.json").write_text(json.dumps({"ranked": cf_run["picks"]}))
    ckpt = save_jax_checkpoint(str(base / "cf_models"), "m", 0,
                               create_train_state(model, model.cfg, TrainConfig()))
    (base / "cf_config.json").write_text(model.cfg.to_json())
    weights = base / "inception_seeded.pt"
    torch.save(build_inception(seed=0, device="cpu").state_dict(), weights)
    saved = os.environ.get(ENV)
    os.environ[ENV] = str(weights)
    try:
        t, fids = _sync_s(lambda: run_counterfactual.main(
            ["--checkpoint", ckpt, "--config", str(base / "cf_config.json"), "--attfind-dir",
             str(att), "--k", "3", "--batch-size", "32", "--classifier-name", "mobilenet"]))
    finally:
        os.environ.pop(ENV, None)
        if saved is not None:
            os.environ[ENV] = saved
    rows = list(csv.reader(open(att / "fid_results.csv")))
    log(f"  (e) run_counterfactual on phase 8's records and picks, the model from a .ckpt: "
        f"FIDs {fids} in {t:.3f} s; fid_results.csv equal to phase 8's: {rows == cf_run['rows']} "
        f"[{card}]")
    if rows != cf_run["rows"]:
        raise AssertionError(f"fid_results.csv {rows} differs from phase 8's {cf_run['rows']}")
    return dict(seconds=t, fids=fids, rows_equal=True)


# ----------------------------------------------------------------- phase 10


def google_upsample_launches(spec, fused: bool) -> int:
    """Kernel #1's launches per forward of Google's generator, from the
    code: one on the RGB skip per resolution above 4 px; per block entry,
    four border strips on the fused graph (``ops/upconv.py``, input of 3x3
    or more) or one upsample on the literal graph."""
    return sum(1 + (4 if fused and res // 2 >= 3 else 1) for res in spec.resolutions[1:])


def google_sweep_upsample_calls(spec, n: int, coord_batch: int) -> int:
    """Upsample calls of one block-resume sweep of Google's generator over
    ``n`` dlatents, from the code (the sweep runs the literal graph): phase
    1's forward, an entry and an RGB-skip upsample per resolution above 4
    px; then per chunk resumed at resolution k, the same two for every
    resolution from max(k, 1) on."""
    r = len(spec.resolutions)
    return 2 * (r - 1) + sum(-(-2 * n * size // coord_batch) * 2 * (r - max(k, 1))
                             for k, size in enumerate(spec.block_sizes))


@contextlib.contextmanager
def _recorded_calls(calls: list):
    """Append (kernel, input shape, dtype) of every resampling kernel call
    inside to ``calls``."""
    from stylex_tpu_torch.ops import blur

    launch = blur._launch

    def recording(name, x, out_shape):
        calls.append((name, tuple(x.shape), x.dtype))
        return launch(name, x, out_shape)

    blur._launch = recording
    try:
        yield
    finally:
        blur._launch = launch


@contextlib.contextmanager
def _resample_graph(fused: bool):
    """Force the fused or the literal resample graph for the calls inside."""
    import os

    from stylex_tpu_torch.ops.fusion import _ENV

    saved = os.environ.get(_ENV)
    os.environ[_ENV] = "0" if fused else "1"
    try:
        yield
    finally:
        os.environ.pop(_ENV, None)
        if saved is not None:
            os.environ[_ENV] = saved


def google_phase(card: str, summary, rates):
    """Phase 10: Google's generator at 256 px, its counterfactual FID, the
    trainer's dispatch knobs, the chunked sweep, the host utilities
    (``summary``: phase 2's, for (e)) and the upsample at the 256-px
    sweeps' chunk shapes (``rates``: the card's, for (f))."""
    from stylex_tpu_torch.device import set_float32_precision

    set_float32_precision()
    base = Path(tempfile.mkdtemp(prefix="stylex_google_", dir=OUT_DIR))
    out = {}
    try:
        t, (out["generator"], gen) = _sync_s(lambda: _google_generator(card))
        out["generator"]["seconds"] = t
        t, out["fid_topk"] = _sync_s(lambda: _google_fid_topk(card, gen, base))
        out["fid_topk"]["seconds"] = t
        del gen
        torch.cuda.empty_cache()
        for key, fn in (("dispatch", lambda: _dispatch_knobs(card, base)),
                        ("chunked_sweep", lambda: _chunked_sweep(card, base)),
                        ("host_utilities", lambda: _host_utilities(card, summary)),
                        ("sweeps", lambda: _sweep_upsample(card, rates))):
            t, out[key] = _sync_s(fn)
            out[key]["seconds"] = t
        log("  phase 10 seconds: " + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in out.items())
            + f" [{card}]")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


def _google_generator(card: str):
    """(a) ``GoogleStylExGenerator()`` (fmap_base 8192, dlatent 514, 256 px,
    the port's seeded weights), batch 8: kernel #1's launches per forward on
    each graph against :func:`google_upsample_launches`; float32 (TF32 off)
    card against CPU (the first 2 images) and fused against literal, within
    1e-4 x max|image|
    (cuDNN and the CPU sum the 13 convolutions in other orders, and the
    fused graph is other ops; expected ~1e-5); a one-hot ``style_delta``
    moves the image and a zero one is the base bit for bit; bf16 finite; ms
    per forward and peak memory, float32 and bf16."""
    import copy

    from stylex_tpu_torch.models.google_stylex import GoogleStylExGenerator
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches

    gen = GoogleStylExGenerator(seed=0)
    spec = gen.spec
    B = GOOGLE_BATCH
    w = torch.randn(B, spec.dlatent_dim, generator=torch.Generator().manual_seed(1)).cuda()
    res, images = {}, {}
    with torch.no_grad():
        for graph in ("fused", "literal"):
            with _resample_graph(graph == "fused"):
                gen.synthesize(w)  # warm-up: cuDNN's and the allocator's first use
                torch.cuda.synchronize()
                reset_launches()
                images[graph] = gen.synthesize(w)
                torch.cuda.synchronize()
                launches = dict(LAUNCHES)
            want = google_upsample_launches(spec, graph == "fused")
            res[f"launches_{graph}"] = launches
            log(f"  (a) one {graph} forward at batch {B}, {spec.image_size} px: launches {launches} "
                f"(upsample derived from the code: {want}) [{card}]")
            if launches["upsample2x_bilinear"] != want or launches["blur3"] != 0:
                raise AssertionError(f"{graph} forward launched {launches}, expected "
                                     f"{want} upsamples and no blur")
        img = images["fused"]
        scale = float(img.abs().max())
        cpu_gen = copy.deepcopy(gen).cpu()
        with _resample_graph(True):  # the first 2 images: the CPU's forward costs seconds
            cpu_img = cpu_gen.synthesize(w[:2].cpu())
        del cpu_gen
        err_cpu = float((img[:2].cpu() - cpu_img).abs().max())
        err_graph = float((images["literal"] - img).abs().max())
        tol = 1e-4 * scale
        log(f"  (a) float32, TF32 off: card vs CPU max abs err {err_cpu:.4g}, fused vs literal "
            f"{err_graph:.4g} (tol 1e-4 x max|image| = {tol:.4g}); image {tuple(img.shape)} "
            f"[{card}]")
        if img.shape != (B, 3, spec.image_size, spec.image_size) or not bool(torch.isfinite(img).all()) \
                or err_cpu > tol or err_graph > tol:
            raise AssertionError(f"Google generator: shape {tuple(img.shape)}, card vs CPU "
                                 f"{err_cpu}, fused vs literal {err_graph} > {tol}")
        C = gen.total_style_coords
        zero = gen.synthesize(w, torch.zeros(B, C, device="cuda"))
        delta = torch.zeros(B, C, device="cuda")
        delta[:, 100] = 5.0
        moved = float((gen.synthesize(w, delta) - img).abs().max())
        log(f"  (a) style_delta: zero reproduces the base bit for bit "
            f"{torch.equal(zero, img)}; one-hot 5.0 at coordinate 100 moves it by max "
            f"{moved:.4g} [{card}]")
        if not torch.equal(zero, img) or not moved > 0:
            raise AssertionError(f"style_delta: zero equal {torch.equal(zero, img)}, "
                                 f"one-hot moved {moved}")
        for dtype in (torch.float32, torch.bfloat16):
            x = w.to(dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(gen.synthesize, x, reps=5, loops=3)
            peak = torch.cuda.max_memory_allocated()
            finite = bool(torch.isfinite(gen.synthesize(x)).all())
            tag = str(dtype).split(".")[-1]
            res[f"ms_{tag}"], res[f"peak_bytes_{tag}"] = ms, peak
            log(f"  (a) {tag} forward (fused graph): {ms:.3f} ms at batch {B} = "
                f"{B / ms * 1e3:.1f} images/s, peak {peak / 2**30:.3f} GiB, finite {finite} "
                f"[{card}]")
            if not finite:
                raise AssertionError(f"{tag} forward not finite")
    res.update(card_vs_cpu_max_abs=err_cpu, fused_vs_literal_max_abs=err_graph,
               max_abs_image=scale, style_delta_moved=moved)
    return res, gen


class _StandIn:
    """The protocol's model pair on the card: ``style_vectors`` from the
    port's generator, ``classify`` by the port's MobileNetV2 (seeded) on
    the [-1, 1] images mapped to [0, 1]."""

    def __init__(self, gen):
        from stylex_tpu_torch.models import build_classifier

        self.gen = gen
        self.clf = build_classifier("mobilenet", gen.spec.image_size, seed=0, device="cuda")

    @torch.no_grad()
    def style_vectors(self, dlatents):
        conv, _ = self.gen.style_vectors(torch.as_tensor(dlatents, device="cuda"))
        return torch.cat(conv, dim=1).cpu().numpy()

    @torch.no_grad()
    def classify(self, images_nhwc):
        x = torch.as_tensor(images_nhwc, device="cuda").permute(0, 3, 1, 2)
        return self.clf.classify_images((x + 1.0) / 2.0).float().cpu().numpy()


def _google_fid_topk(card: str, gen, base: Path):
    """(b) ``google_fid_topk`` on the card: 16 originals (the generator's
    own images of 16 seeded dlatents), 16 other seeded dlatents, k = 1, the
    seeded InceptionV3 (phase 8's) through ``STYLEX_TPU_INCEPTION``: finite
    FIDs, seconds split into the host's ``frechet_distance``, feature
    statistics and the rest (generation, classification); both kernels'
    launches counted from 0."""
    import os

    from stylex_tpu_torch import ingest_tf
    from stylex_tpu_torch.eval import fid as fid_mod
    from stylex_tpu_torch.models.inception import ENV, build_inception
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches

    n = 16
    rng = np.random.RandomState(7)
    latents = rng.randn(n, gen.spec.dlatent_dim).astype(np.float32)
    with torch.no_grad():
        orig = gen.call_synthesis(torch.from_numpy(rng.randn(n, gen.spec.dlatent_dim)
                                                   .astype(np.float32)).cuda())
    originals = ((orig.permute(0, 2, 3, 1).cpu().numpy() + 1.0) / 2.0).clip(0.0, 1.0)
    weights = base / "inception_seeded.pt"
    torch.save(build_inception(seed=0, device="cpu").state_dict(), weights)
    saved = os.environ.get(ENV)
    os.environ[ENV] = str(weights)
    try:
        models = _StandIn(gen)
        picks = [(0, 100)]
        reset_launches()
        with _Timed(fid_mod, "frechet_distance") as fd, \
                _Timed(fid_mod, "compute_feature_stats") as fs:
            t, fids = _sync_s(lambda: ingest_tf.google_fid_topk(
                models, originals, latents, picks, k=1, batch_size=8,
                generator=(gen.spec, gen), csv_path=str(base / "google_fid.csv")))
        launches = dict(LAUNCHES)
    finally:
        os.environ.pop(ENV, None)
        if saved is not None:
            os.environ[ENV] = saved
    split = dict(total_s=t, frechet_s=sum(fd.seconds), features_s=sum(fs.seconds),
                 generation_s=t - sum(fd.seconds) - sum(fs.seconds))
    log(f"  (b) google_fid_topk, {n} originals at 256 px, k = 1: FIDs {fids}; "
        f"{json.dumps(split)}; launches {launches} [{card}]")
    if len(fids) != 2 or not all(np.isfinite(fids)) or len(fd.seconds) != 2:
        raise AssertionError(f"google_fid_topk: FIDs {fids}, frechet calls {len(fd.seconds)}")
    if launches["upsample2x_bilinear"] <= 0:
        raise AssertionError("google_fid_topk did not launch the upsample kernel")
    return dict(fids=fids, launches=launches, **split)


def _sweep_upsample(card: str, rates):
    """(f) The upsample at the chunk shapes of the two 256-px sweep cells.
    One float32 block-resume sweep each (TF32 off) at the cells' parameters
    (``coord_batch`` 512, 8 chunks a copy, MobileNetV2 at 256 px, seeded
    weights): Google's generator over 1 dlatent (``google256.latent_attfind``)
    and the ``ffhq256`` StylEx over 4 images (``ffhq256.attfind``), with each
    kernel call's input shape recorded and the launches counted from 0:
    Google's upsample calls against :func:`google_sweep_upsample_calls`,
    each one launch, and no blur. Then at every distinct upsample input
    shape met: the kernel against its plain version bit for bit (the plain
    version in batch slices: its temporaries at the largest shapes would
    not fit beside the kernel's output), its device ms by CUDA events and
    its share of the bytes bound. The largest outputs pass 2^31 elements."""
    from stylex_tpu_torch.attfind.extraction import attfind_extraction
    from stylex_tpu_torch.config import Arch, ModelConfig
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.models import build_classifier, build_stylex
    from stylex_tpu_torch.models.google_stylex import GoogleStylExGenerator
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.ops.blur import launch_geometry, upsample2x_bilinear, \
        upsample2x_bilinear_plain
    from stylex_tpu_torch.ops.latents import image_noise

    def google():
        gen = GoogleStylExGenerator(seed=0)
        dl = np.random.RandomState(3).randn(1, gen.spec.dlatent_dim).astype(np.float32)
        return gen, dl, None, gen.spec.image_size

    def ffhq():
        c = json.loads((ROOT / "benchmark/configs/ffhq256.json").read_text())["model"]
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        cfg = ModelConfig(**{k: v for k, v in c.items() if k in names and k != "arch"},
                          arch=Arch(c["arch"]))
        ds = SyntheticImageDataset(4, cfg.image_size, seed=1)
        images = np.stack([ds[i] for i in range(4)])
        noise = image_noise(torch.Generator().manual_seed(7), 1, cfg.image_size).numpy()
        return build_stylex(cfg, seed=0, device="cuda"), images, noise, cfg.image_size

    out, shapes = {}, set()
    for cell, build in (("google256.latent_attfind", google), ("ffhq256.attfind", ffhq)):
        model, inputs, noise, size = build()
        clf = build_classifier("mobilenet", size, seed=0, device="cuda")
        calls = []
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with _recorded_calls(calls):
            t, rec = _sync_s(lambda: attfind_extraction(
                model, clf.classify_images, inputs, noise, coord_batch=SWEEP_COORD_BATCH,
                chunks_per_dispatch=8, compute_dtype=torch.float32, progress=False))
        launches = dict(LAUNCHES)
        styles = rec.style_change.shape[0] * 2 * rec.style_change.shape[2]
        up = [s for name, s, dtype in calls if name == "upsample2x_bilinear"]
        geometry = sum(len(launch_geometry("upsample2x_bilinear", s[0] * s[1], s[2], s[3], 4,
                                           0, 0)[3]) for s in up)
        res = dict(seconds=t, styles=styles, launches=launches, upsample_calls=len(up),
                   upsample_shapes=sorted(set(up)), peak_bytes=torch.cuda.max_memory_allocated(),
                   finite=bool(np.isfinite(rec.style_change).all()))
        log(f"  (f) {cell}: one sweep of {styles} styles in {t:.2f} s (first call), "
            f"launches {launches}, {len(up)} upsample calls at {len(set(up))} shapes, "
            f"peak {res['peak_bytes'] / 2**30:.2f} GiB [{card}]")
        if not res["finite"] or launches["upsample2x_bilinear"] != geometry or \
                any(dtype != torch.float32 for _, _, dtype in calls):
            raise AssertionError(f"{cell}: records finite {res['finite']}, upsample launches "
                                 f"{launches['upsample2x_bilinear']} against {geometry} from "
                                 f"the calls' geometry, dtypes {set(d for _, _, d in calls)}")
        if isinstance(model, GoogleStylExGenerator):
            want = google_sweep_upsample_calls(model.spec, len(inputs), SWEEP_COORD_BATCH)
            res["upsample_calls_from_code"] = want
            log(f"  (f) {cell}: upsample calls {len(up)}, from the code {want}; blur "
                f"{launches['blur3']} [{card}]")
            if len(up) != want or launches["blur3"] != 0:
                raise AssertionError(f"Google sweep: {len(up)} upsample calls against {want} "
                                     f"from the code, {launches['blur3']} blurs")
        out[cell] = res
        shapes.update(up)
        del model, clf, rec
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in sorted(shapes, key=lambda s: -int(np.prod(s))):
        x = torch.randn(shape, generator=gen, device="cuda")
        y = upsample2x_bilinear(x)
        step = max(1, 2 ** 28 // (4 * int(np.prod(shape[1:]))))  # 1 GiB of plain output a slice
        err, equal = 0.0, True
        for i in range(0, shape[0], step):
            want = upsample2x_bilinear_plain(x[i:i + step])
            if not torch.equal(y[i:i + step], want):
                equal = False
                err = max(err, float((y[i:i + step] - want).abs().max()))
            del want
        del y
        ms = time_ms(upsample2x_bilinear, x, reps=3, loops=3)
        bound = 5 * x.numel() * 4 / rates[0] * 1e3
        rows.append(dict(shape=list(shape), out_elements=4 * x.numel(), equal=equal,
                         max_abs_err=err, ms=ms, bound_ms=bound, bound_share=bound / ms))
        log(f"  (f) upsample float32 {str(shape):22s} out {4 * x.numel():>13,d} elements: "
            f"bit for bit {equal} (max abs err {err:.3g}), {ms:.4f} ms, {bound / ms:.3f} of "
            f"the bytes bound [{card}]")
        del x
        torch.cuda.empty_cache()
    out["rows"] = rows
    bad = [r["shape"] for r in rows if not r["equal"]]
    if bad:
        raise AssertionError(f"upsample kernel differs from its plain version at {bad}")
    return out


def _checkpoint_tensors(payload, clone: bool = False):
    """name -> tensor of a checkpoint's model state dict and both Adam
    states (moments and counts), on the card."""
    out = {f"model.{k}": v for k, v in payload["StylEx"].items()}
    for opt in ("g_opt", "d_opt"):
        for i, st in payload[opt]["state"].items():
            for k, v in st.items():
                out[f"{opt}.{i}.{k}"] = torch.as_tensor(v)
    return {k: (v.detach().clone() if clone else v).cuda() for k, v in out.items()}


def _state_copy(state) -> dict:
    """A copy, on the card, of a train state: the model's state dict, both
    Adam states, ``pl_mean`` and the step."""
    import copy

    return dict(model={k: v.detach().clone() for k, v in state.model.state_dict().items()},
                g_opt=copy.deepcopy(state.g_opt.state_dict()),
                d_opt=copy.deepcopy(state.d_opt.state_dict()),
                pl_mean=state.pl_mean.detach().clone(), step=state.step)


def _state_restore(state, saved: dict) -> None:
    import copy

    state.model.load_state_dict(saved["model"])
    state.g_opt.load_state_dict(copy.deepcopy(saved["g_opt"]))
    state.d_opt.load_state_dict(copy.deepcopy(saved["d_opt"]))
    state.pl_mean, state.step = saved["pl_mean"].clone(), saved["step"]


def _dispatch_run(card: str, base: Path, label: str, k: int, lag: int, async_save: bool,
                  timed: bool = True, record=None, replay=None, steps: int = 8):
    """``steps`` steps of the CLI-default trainer (float32, a save every 4)
    from seed 0 with the given knobs. ``timed``: wall and device time and the busy
    share of steps 1-7 (``torch.profiler``), launches, and checkpoint 1 (of
    step 4) held bit for bit against the state at its save. ``record``
    (a dict) receives the state before each step; ``replay`` (such a dict)
    sets the state before each step from 1 on."""
    from torch.profiler import ProfilerActivity, profile

    from stylex_tpu_torch.config import ModelConfig, TrainConfig
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.profile_sweep import device_summary
    from stylex_tpu_torch.train.trainer import Trainer

    t_run = time.perf_counter()
    tc = TrainConfig(save_every=4, evaluate_every=1000, num_image_tiles=4, steps_per_dispatch=k,
                     metrics_lag=lag, async_save=async_save, num_train_steps=steps)
    t = Trainer(name=f"smoke10-{label}", base_dir=str(base / label), model_cfg=ModelConfig(),
                train_cfg=tc, classifier_name="resnet", seed=0)
    logged = _logged_metrics(t)
    res = {}
    try:
        t.set_data_src(dataset_name="synthetic")
        t.init_stylex()
        if record is not None:
            inner = t._step_fn

            def recording(state, batch, draws):
                record[state.step] = _state_copy(state)
                return inner(state, batch, draws)

            t._step_fn = recording
        t.train()  # step 0: a boundary, a block of one, with the first save
        torch.cuda.synchronize()
        sizes, snapshot = [1], None
        reset_launches()
        # the device's activity only: the busy share needs no host events
        with profile(activities=[ProfilerActivity.CUDA]) if timed \
                else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            while t.steps < steps:
                if replay is not None:
                    _state_restore(t.state, replay[t.steps])
                before = t.steps
                t.train()
                sizes.append(t.steps - before)
                if t.steps == 5 and timed:  # checkpoint 1, of step 4, was just submitted
                    snapshot = _checkpoint_tensors(dict(
                        StylEx=t.state.model.state_dict(), g_opt=t.state.g_opt.state_dict(),
                        d_opt=t.state.d_opt.state_dict()), clone=True)
                    pl_mean = float(t.state.pl_mean)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)
        t.flush()
    finally:
        t.close()
    res.update(sizes=sizes, steps=sorted(logged), metrics=logged, launches=launches)
    if not timed:
        res["seconds"] = time.perf_counter() - t_run
        return res
    _, device_ms, busy, _ = device_summary(prof, 7, wall_ms)
    path = base / label / "models" / f"smoke10-{label}" / "model_1.pt"
    stored = torch.load(path, map_location="cuda", weights_only=True)
    tensors = _checkpoint_tensors(stored)
    unequal = sorted(k_ for k_ in set(snapshot) | set(tensors)
                     if k_ not in snapshot or k_ not in tensors
                     or not torch.equal(tensors[k_], snapshot[k_]))
    pl_equal = stored["pl_mean"] == pl_mean
    res.update(ms_per_step=wall_ms / 7, device_ms_per_step=device_ms, busy_share=busy,
               checkpoint_unequal=unequal, checkpoint_step=stored["step"],
               seconds=time.perf_counter() - t_run)
    log(f"  (c) {label} (steps_per_dispatch {k}, metrics_lag {lag}, async_save "
        f"{async_save}): blocks {sizes}, logged steps {sorted(logged)}; steps 1-7 "
        f"{wall_ms / 7:.1f} ms/step wall, {device_ms:.1f} ms/step device time, device busy "
        f"{busy:.3f}; checkpoint 1 (step {stored['step']}) against the state at its save: "
        f"{len(unequal)} unequal tensors, pl_mean equal {pl_equal}; launches {launches} "
        f"[{card}]")
    if unequal or not pl_equal or stored["step"] != 5:
        raise AssertionError(f"{label}: checkpoint 1 differs from the state at its save: "
                             f"{unequal[:5]}, pl_mean {pl_equal}, step {stored['step']}")
    for name in ON_PATH:
        if launches[name] <= 0:
            raise AssertionError(f"{label} training did not launch kernel {name}")
    return res


def _loss_err(a: dict, b: dict) -> float:
    """The largest |a - b| over steps and losses, as a share of phase 6's
    tolerance for losses, atol + rtol |b|."""
    return max(abs(a[s][key] - b[s][key]) / (CPU_ATOL + CPU_RTOL * abs(b[s][key]))
               for s in b for key in b[s])


def _dispatch_knobs(card: str, base: Path):
    """(c) The CLI-default trainer in float32, 8 steps with a save every 4,
    from seed 0: blocks of ``steps_per_dispatch=4`` with ``metrics_lag=8``
    and ``async_save``, and one step at a time, synchronous. The block
    sizes are the boundary rule's and the logged steps the same; each
    background checkpoint of step 4 (parameters, buffers, Adam moments and
    counts, ``pl_mean``) loads back equal, bit for bit, to the state at its
    save; wall ms/step and the device's busy share of both. The card's
    float32 steps do not repeat bit for bit (phase 9 (a) shows it), and this
    model's first steps (losses in the thousands at random weights) magnify
    that step by step, so the two free runs' losses are reported; the
    losses are held to phase 6's tolerance from equal states: a third run
    (steps 0-4: step 0 and one whole block) records the state before each
    step, and a fourth, one step at a time, starts each step from that
    state."""
    blocks = _dispatch_run(card, base, "blocks", 4, 8, True)
    sync = _dispatch_run(card, base, "sync", 1, 0, False)
    states: dict = {}  # steps 0-4: step 0 and one whole block
    recorded = _dispatch_run(card, base, "blocks-rec", 4, 8, True, timed=False, record=states,
                             steps=5)
    replayed = _dispatch_run(card, base, "replay", 1, 0, False, timed=False, replay=states,
                             steps=5)
    del states
    torch.cuda.empty_cache()
    for r, want in ((blocks, [1, 4, 3]), (sync, [1] * 8), (recorded, [1, 4]),
                    (replayed, [1] * 5)):
        if r["sizes"] != want or r["steps"] != list(range(sum(want))):
            raise AssertionError(f"blocks {r['sizes']} (want {want}), logged {r['steps']}")
    free = {s: max(abs(blocks["metrics"][s][key] - sync["metrics"][s][key])
                   / max(abs(sync["metrics"][s][key]), 1e-30)
                   for key in sync["metrics"][s]) for s in range(8)}
    log("  (c) free runs, blocks against one step at a time, max rel loss diff per step: "
        + ", ".join(f"{s}: {v:.3g}" for s, v in free.items()) + f" [{card}]")
    err = _loss_err(recorded["metrics"], replayed["metrics"])
    log("  (c) seconds per run: " + ", ".join(
        f"{label} {r['seconds']:.1f}" for label, r in (("blocks", blocks), ("sync", sync),
                                                      ("recorded", recorded),
                                                      ("replayed", replayed))) + f" [{card}]")
    for step in range(5):
        log(f"  (c) step {step} from the same state: " + ", ".join(
            f"{key} {recorded['metrics'][step][key]:.7g} / {replayed['metrics'][step][key]:.7g}"
            for key in replayed["metrics"][step]) + " (blocks / one step)")
    log(f"  (c) losses of each step from the same state, blocks against one step at a time: "
        f"max |diff| {err:.3g} of phase 6's tolerance (rtol {CPU_RTOL}, atol {CPU_ATOL}) "
        f"[{card}]")
    if err > 1.0:
        raise AssertionError(f"a block step's losses differ from a one-step call's from the "
                             f"same state: {err} of the tolerance")
    for r in (blocks, sync):
        del r["metrics"]
    return dict(blocks=blocks, sync=sync, free_rel_diff_per_step=free, loss_err_of_tol=err)


def _chunked_sweep(card: str, base: Path):
    """(d) ``run_attfind`` on phase 3's 4 synthetic images (64px config,
    seeded weights saved as a ``.pt``, MobileNetV2, bf16, ``coord_batch``
    616) with ``--chunks-per-dispatch`` 1, 8, 8 and 1 (in turns): the
    records equal bit for bit (else within phase 3's 32 bf16 ulps, and the
    result says which); styles/s of the extraction in each."""
    from stylex_tpu_torch import attfind, run_attfind
    from stylex_tpu_torch.config import ModelConfig, TrainConfig
    from stylex_tpu_torch.models import build_stylex
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.train.state import create_train_state
    from stylex_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = ModelConfig()
    models = base / "sweep_models"
    model = build_stylex(cfg, seed=0, device="cpu")  # phase 3's seeded weights
    save_checkpoint(str(models), "m", 1, create_train_state(model, cfg, TrainConfig()))
    (models / "m" / ".config.json").write_text(cfg.to_json())
    got, res = {}, {}
    for run, K in enumerate((1, 8, 8, 1)):  # in turns: the first run carries first-use costs
        out = base / f"sweep{run}"
        reset_launches()
        with _Timed(attfind, "attfind_extraction") as tx:
            run_attfind.main(["--name", "m", "--base-dir", str(base), "--models-dir",
                              "sweep_models", "--classifier-name", "mobilenet", "--dataset-name",
                              "synthetic", "--num-images", str(N_IMAGES), "--coord-batch",
                              str(COORD_BATCH), "--dtype", "bfloat16", "--chunks-per-dispatch",
                              str(K), "--results-folder", str(out)])
        got[run] = attfind.load_records(str(out / attfind.records_file_name()))
        styles = got[run].style_change.shape[0] * 2 * got[run].style_change.shape[2]
        res[f"run{run}_k{K}"] = dict(seconds=tx.seconds[0], styles_per_s=styles / tx.seconds[0],
                                     launches=dict(LAUNCHES))
        for name in ON_PATH:
            if LAUNCHES[name] <= 0:
                raise AssertionError(f"run_attfind --chunks-per-dispatch {K} did not launch "
                                     f"{name}")
    fields = ("style_change", "latents", "base_prob", "minima", "maxima", "style_coordinates",
              "discriminator")
    diffs = {f: max(float(np.abs(getattr(got[r], f) - getattr(got[0], f)).max())
                    for r in (1, 2, 3)) for f in fields}
    bitwise = all(d == 0.0 for d in diffs.values())
    tol = 32 * bf16_ulp(float(np.abs(got[0].base_prob).max()))
    log(f"  (d) run_attfind --chunks-per-dispatch 1, 8, 8, 1: max |diff| against the first "
        f"{diffs}; bit for bit {bitwise} (else tol {tol:.4g}); styles/s of the extraction "
        + ", ".join(f"{k} {v['styles_per_s']:.1f}" for k, v in res.items())
        + f"; launches {res['run1_k8']['launches']} [{card}]")
    if not bitwise and max(diffs.values()) > tol:
        raise AssertionError(f"chunked sweep records differ: {diffs} > {tol}")
    return dict(res, max_abs_diff=diffs, bitwise=bitwise, tol=tol)


def _host_utilities(card: str, summary):
    """(e) The C++ pixel pipeline built and taken by ``load_and_transform``
    (its call count), equal to the PIL path within 2.5/255 (expected 0);
    ``measure_op`` (its chained loop replayed as a CUDA graph) on kernel #1
    at the sweep-chunk shapes (bf16) against phase 2's device ms (within
    2x) and the roofline guard (no raise)."""
    from PIL import Image

    from stylex_tpu_torch import native
    from stylex_tpu_torch.data import FolderDataset
    from stylex_tpu_torch.ops import blur as ops
    from stylex_tpu_torch.utils.timing import measure_op

    if not native.available():
        raise AssertionError(f"the native pixel pipeline did not build: {native.build_error}")
    base = Path(tempfile.mkdtemp(prefix="stylex_native_", dir=OUT_DIR))
    try:
        rng = np.random.RandomState(0)
        for i, size in enumerate(((300, 200), (64, 96), (517, 389), (40, 40))):
            Image.fromarray(rng.randint(0, 256, size=size[::-1] + (3,)).astype(np.uint8)).save(
                base / f"{i}.png")
        ds = FolderDataset(str(base), 64)
        before = native.CALLS["resize_crop_normalize"]
        got = [ds[i] for i in range(len(ds))]
        calls = native.CALLS["resize_crop_normalize"] - before
        available = native.available
        native.available = lambda: False
        try:
            want = [ds[i] for i in range(len(ds))]
        finally:
            native.available = available
    finally:
        shutil.rmtree(base, ignore_errors=True)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    log(f"  (e) native pipeline built ({native.library_path().name}); load_and_transform took it "
        f"{calls} times for {len(got)} images; max |native - PIL| {err * 255:.3g}/255 "
        f"(tol 2.5/255) [{card}]")
    if calls != len(got) or err > 2.5 / 255:
        raise AssertionError(f"native path: {calls} calls for {len(got)} images, error {err}")
    shapes = kernel_shapes()["upsample2x_bilinear"]["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = 0.0
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        t = measure_op(ops.upsample2x_bilinear, [x], repeats=3,
                       bytes_moved=5 * x.numel() * x.element_size())
        total += t.seconds * 1e3
    device = summary["upsample2x_bilinear"]["device_ms"]
    log(f"  (e) measure_op on the upsample at the sweep chunk's {len(shapes)} shapes (bf16): "
        f"{total:.4f} ms summed against phase 2's device ms {device:.4f} (ratio "
        f"{total / device:.3f}, must be within 2x); roofline guard passed [{card}]")
    if not 0.5 <= total / device <= 2.0:
        raise AssertionError(f"measure_op {total} ms against device {device} ms: beyond 2x")
    return dict(native_calls=calls, native_vs_pil_max_abs=err, measure_op_ms=total,
                phase2_device_ms=device)

# ----------------------------------------------------------------- phase 11


def _tree_err(got: dict, want: dict, prefix: str = "") -> float:
    """The largest |got - want| over each tree's tensors (keys
    ``<prefix><tree>.``), as a share of that tree's largest |want|."""
    worst = 0.0
    for tree in ("encoder", "S", "G", "D"):
        keys = [k for k in want if k.startswith(f"{prefix}{tree}.")]
        if not keys:
            continue
        scale = max(float(want[k].abs().max()) for k in keys)
        worst = max(worst, max(float((got[k] - want[k]).abs().max()) for k in keys) / scale)
    return worst


def parallel_phase(card: str, cards: int = 1):
    """Phase 11: data parallelism on the one card, float32 with TF32 off.
    Three runs of the same work: (1) one process, no process group; (2)
    ``launch`` with one rank (NCCL); (3) two ranks on cuda:0 (gloo), 2
    images a rank per micro-batch. Each runs (a) one plain train step from
    the seeded weights as trained and with the kinks smoothed, then the
    CLI-default trainer for 5 steps; (1) and (3) run (b) ``run_attfind
    --name`` at the ``bench.py`` config (one process through the CLI's
    ``main``, two ranks through its rank function in (3)'s group). With
    ``cards`` above 1 a fourth run does (a) and (b) on that many cards, one
    rank each (NCCL)."""
    from stylex_tpu_torch import run_attfind
    from stylex_tpu_torch.config import ModelConfig, TrainConfig
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.models import build_stylex
    from stylex_tpu_torch.models.lpips import init_lpips_params
    from stylex_tpu_torch.ops import reset_launches
    from stylex_tpu_torch.parallel import launch, make_mesh
    from stylex_tpu_torch.testing import harness
    from stylex_tpu_torch.train import draw_step
    from stylex_tpu_torch.train.state import create_train_state
    from stylex_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = ModelConfig()
    tc = TrainConfig(pl_start_step=0, pl_every=4, ema_start_step=0, ema_every=2,
                     save_every=1000, evaluate_every=1000, num_image_tiles=4)
    step_tc = dataclasses.replace(tc, pl_start_step=-1, aug_prob=0.25)  # GP and PL at step 0
    A, B = tc.gradient_accumulate_every, tc.batch_size
    ds = SyntheticImageDataset(3 * A * B, cfg.image_size)
    imgs = np.stack([ds[i] for i in range(3 * A * B)]).reshape(3, A, B, *ds[0].shape)
    step = dict(model_cfg=cfg, train_cfg=step_tc, state_dict=None, seed=0, step=0, pl_mean=0.5,
                classifier=("resnet", cfg.image_size, cfg.num_classes, None),
                lpips=init_lpips_params(device="cpu"), optimizer=tc.lr, every_rank=False,
                draws=draw_step(torch.Generator().manual_seed(7), cfg, step_tc, B,
                                int(np.log2(cfg.image_size)) - 1, 0.25, 0),
                batch=dict(zip(("d_real", "d_enc", "g_imgs"), imgs)))
    base = Path(tempfile.mkdtemp(prefix="stylex_parallel_", dir=OUT_DIR))
    try:
        (base / "models" / "bench").mkdir(parents=True)
        (base / "models" / "bench" / ".config.json").write_text(cfg.to_json())
        save_checkpoint(str(base / "models"), "bench", 1, create_train_state(
            build_stylex(cfg, seed=0, device="cpu"), cfg, TrainConfig()))
        argv = ["--name", "bench", "--base-dir", str(base), "--models-dir", "models",
                "--classifier-name", "mobilenet", "--dataset-name", "synthetic",
                "--num-images", str(N_IMAGES), "--coord-batch", str(COORD_BATCH),
                "--dtype", "float32"]

        def cases(label, sweep=False):
            trainer = dict(name=f"parallel-{label}", base_dir=str(base), model_cfg=cfg,
                           train_cfg=tc, classifier_name="resnet", seed=0, tensorboard_dir=None)
            out = [("step", dict(step, keep=("state_dict",))),
                   ("step", dict(step, smooth_kinks=1e-2, keep=("grads",))),
                   ("trainer", dict(steps=5, snapshot_after=0, trainer=trainer))]
            if sweep:
                out.append(("run_attfind", argv + ["--results-folder", str(base / label)]))
            return out

        def sweep_process():
            reset_launches()  # from 0, as in a spawned rank
            # one process even where the CLI's default would take every card
            return [run_attfind.extract(make_mesh(1, "cuda"), run_attfind.parse_args(
                argv + ["--results-folder", str(base / "sweep_process")]))]

        spec = [("process", lambda: [harness.run(make_mesh(1, "cuda"), cases("process"))]),
                ("nccl_1", lambda: launch(harness.run, 1, "cuda", args=(cases("nccl_1"),))),
                ("gloo_2", lambda: launch(harness.run, 2, ["cuda:0", "cuda:0"],
                                          args=(cases("gloo_2", sweep=True),)))]
        if cards > 1:
            spec.append((f"nccl_{cards}", lambda: launch(
                harness.run, cards, "cuda", args=(cases(f"nccl_{cards}", sweep=True),))))
        runs, seconds = {}, {}
        for label, run in spec + [("sweep_process", sweep_process)]:
            t = time.perf_counter()
            runs[label] = run()
            seconds[label] = time.perf_counter() - t
        train = _parallel_train(card, runs, seconds)
        sweep = _parallel_sweep(card, runs, base, [label for label, _ in spec[2:]])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"  phase 11 seconds per run: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f" [{card}]")
    return dict(train=train, sweep=sweep, seconds_per_run=seconds)


def _parallel_train(card: str, runs: dict, seconds: dict):
    """(a) The plain step (GP and PL on): metrics (phase 6's rtol) and
    parameters (phase 6's tolerance) as trained, and the gradients per tree
    with the kinks smoothed (phase 6's 1e-4 x max|g|; as trained, the
    ranks' other float32 summation order flips activations at the kinks,
    as the card's and the CPU's do in phase 6), of the group of one and the
    two ranks against one process. The trainer (Adam; GP at 0 and 4, the
    EMA reset at 2, PL and an EMA update at 4): step 0's losses against one
    process; every rank's state after step 4 equal to rank 0's bit for
    bit; losses finite; both kernels launched in every rank; ms per step
    and the gradient all-reduce's bytes and ms per step. Adam's step-0
    gradients (its first moments) are reported: the G phase runs on the D
    that Adam moved, and Adam's first step maps a gradient within rounding
    of 0 to +-lr."""
    (want_step, want_smooth, want), out = runs["process"][0], {}
    for label in (label for label in runs if label != "sweep_process"):
        ranks = [r[:3] for r in runs[label]]
        r_step, r_smooth, r0 = ranks[0]
        m_err = max(abs(r_step["metrics"][k] - v) / max(abs(v), 1e-30)
                    for k, v in want_step["metrics"].items())
        g_err = _tree_err(r_smooth["grads"], want_smooth["grads"])
        p_err = max(float(((r_step["state_dict"][k] - v).abs()
                           / (CPU_ATOL + CPU_RTOL * v.abs())).max())
                    for k, v in want_step["state_dict"].items() if v.is_floating_point())
        m0 = r0["metrics"][0]
        loss_err = max(abs(m0[k] - v) / max(abs(v), 1e-30) for k, v in want["metrics"][0].items())
        adam_err = {phase: _tree_err(r0["snapshot"], want["snapshot"], f"{phase}_opt.")
                    for phase in ("d", "g")}
        bitwise = len(ranks) == 1 or all(r[-1]["state"] == r0["state"] for r in ranks[1:])
        finite = all(np.isfinite(v) for r in ranks for m in r[-1]["metrics"].values()
                     for v in m.values())
        ms = statistics.median(r0["ms"][1:])
        reduce = r0.get("grad_all_reduce")
        launches = [r[-1]["launches"] for r in ranks]
        out[label] = dict(ranks=len(ranks), step_metrics=r_step["metrics"],
                          step_metric_rel_err=m_err, step_grad_err_smooth=g_err,
                          step_param_err=p_err, train_step0=m0,
                          train_step0_loss_rel_err=loss_err, train_step0_adam_grad_err=adam_err,
                          ranks_bitwise=bitwise, ms_per_step=ms, ms=r0["ms"], launches=launches,
                          grad_all_reduce=reduce, metrics=r0["metrics"], seconds=seconds[label])
        log(f"  (a) {label}, {len(ranks)} rank(s): one plain step against one process: metrics "
            f"{m_err:.3g} (rtol {CPU_RTOL}), parameters {p_err:.3g} of phase 6's bound "
            f"(must be <= 1), gradients with the kinks smoothed {g_err:.3g} x max|g| (tol "
            f"{CPU_ATOL}); Trainer: median {ms:.1f} ms/step over steps 1-4"
            + (" (two ranks sharing one card: not a speed figure)" if label == "gloo_2" else "")
            + f", step 0 losses {m0}, max rel diff {loss_err:.3g} "
            f"(rtol {CPU_RTOL}), Adam's step-0 gradients x max|g| (reported) D phase "
            f"{adam_err['d']:.3g}, G phase {adam_err['g']:.3g}; ranks bit-equal after step 4: "
            f"{bitwise}; launches per rank {launches}"
            + (f"; gradient all-reduce {reduce['bytes_per_step']:.0f} bytes/step, "
               f"{reduce['ms']:.3f} ms/step" if reduce else "")
            + f"; the run took {seconds[label]:.1f} s [{card}]")
        if label != "process" and (m_err > CPU_RTOL or g_err > CPU_ATOL or p_err > 1
                                   or loss_err > CPU_RTOL):
            raise AssertionError(f"{label} differs from one process: step metrics {m_err}, "
                                 f"gradients {g_err}, parameters {p_err}, trainer losses "
                                 f"{loss_err}")
        if not (bitwise and finite):
            raise AssertionError(f"{label}: ranks bit-equal {bitwise}, losses finite {finite}")
        gp = [r0["metrics"][i]["gp"] for i in range(5)]
        pl = [r0["metrics"][i]["pl_mean"] for i in range(5)]
        if not (gp[0] > 0 and gp[4] > 0 and gp[1] == gp[2] == gp[3] == 0 and pl[3] == -1.0
                and pl[4] >= 0):
            raise AssertionError(f"{label}: GP {gp} and PL {pl} off their steps")
        for rank, counts in enumerate(launches):
            for name in ON_PATH:
                if counts[name] <= 0:
                    raise AssertionError(f"{label} rank {rank} did not launch {name}")
    return out


def _parallel_sweep(card: str, runs: dict, base: Path, sharded: list):
    """(b) ``run_attfind --name`` at the ``bench.py`` config (phase 3's
    seeded model saved as a checkpoint, MobileNetV2, 4 synthetic images,
    ``coord_batch=616``, float32, block-resume), the ``sharded`` runs' ranks
    (two on cuda:0 under gloo; one a card under NCCL) against one process:
    records within phase 3's float32 bound, both kernels launched in every
    rank, styles/s of each."""
    from stylex_tpu_torch.attfind import load_records, records_file_name

    want = load_records(str(base / "sweep_process" / records_file_name()))
    fields = ("style_change", "latents", "base_prob", "minima", "maxima", "style_coordinates",
              "discriminator")
    summaries = {"process": runs["sweep_process"],
                 **{label: [r[3] for r in runs[label]] for label in sharded}}
    out = {label: dict(ranks=len(r), seconds=r[0]["seconds"],
                       styles_per_s=r[0]["styles"] / r[0]["seconds"],
                       launches=[x["launches"] for x in r]) for label, r in summaries.items()}
    for label in sharded:
        got = load_records(str(base / label / records_file_name()))
        over = {f: float((np.abs(getattr(got, f) - getattr(want, f))
                          - (CPU_ATOL + CPU_RTOL * np.abs(getattr(want, f)))).max())
                for f in fields}
        out[label]["max_abs_diff"] = diff = {
            f: float(np.abs(getattr(got, f) - getattr(want, f)).max()) for f in fields}
        log(f"  (b) run_attfind, {label} against one process: max |diff| {diff} (bound "
            f"{CPU_ATOL} + {CPU_RTOL} x |x|, phase 3's float32 one); launches per rank "
            f"{out[label]['launches']} [{card}]")
        if max(over.values()) > 0:
            raise AssertionError(f"{label} records beyond the bound: {diff}")
    log(f"  (b) styles/s " + ", ".join(f"{k} {v['styles_per_s']:.1f} ({v['ranks']} rank(s))"
                                      for k, v in out.items())
        + f" (two ranks sharing one card: not a speed figure) [{card}]")
    for label, res in out.items():
        for rank, launches in enumerate(res["launches"]):
            for name in ON_PATH:
                if launches[name] <= 0:
                    raise AssertionError(f"(b) {label} rank {rank} did not launch {name}")
    return out


# ------------------------------------------------------------------ phase 12


# (name, input, weight, stride, padding, groups): the main path's float32
# convolutions under autograd at batch 32, then small, ragged and strided ones
COLUMN_MAIN = [
    ("D 3x3, 64 ch, 256 px", (32, 64, 256, 256), (64, 64, 3, 3), 1, 1, 1),
    ("D fused downsample 5x5 stride 2", (32, 64, 259, 259), (64, 64, 5, 5), 2, 0, 1),
    ("G 3x3, 32 ch, 256 px", (32, 32, 256, 256), (32, 32, 3, 3), 1, 1, 1),
]
COLUMN_EXTRA = [
    ("depthwise 3x3 stride 2", (32, 96, 128, 128), (96, 1, 3, 3), 2, 1, 96),
    ("1x1 residual stride 2", (32, 256, 64, 64), (512, 256, 1, 1), 2, 0, 1),
    ("3x3 at 4 px", (32, 512, 4, 4), (512, 512, 3, 3), 1, 1, 1),
    ("3x3 at 2 px", (16, 512, 2, 2), (512, 512, 3, 3), 1, 1, 1),
    ("up-conv strip", (32, 128, 3, 128), (128, 128, 3, 3), 1, 1, 1),
    ("odd 3x3 stride 2", (4, 5, 9, 7), (6, 5, 3, 3), 2, 1, 1),
    ("5x5 padded", (4, 3, 7, 11), (4, 3, 5, 5), 1, 2, 1),
    ("wide row, split tiles", (2, 3, 5, 1500), (4, 3, 3, 3), 1, 1, 1),
]


def _conv2d_gemm_autograd(x, weight, bias, stride, padding, groups):
    """``ops.conv.conv2d_gemm`` as PR 2 wrote it: pad, strided window views
    and one copy, differentiated by autograd (the yardstick of phase 12)."""
    import torch.nn.functional as F

    n, c, _, _ = x.shape
    o, _, kh, kw = weight.shape
    if padding:
        x = F.pad(x, (padding,) * 4)
    win = x.unfold(2, kh, stride).unfold(3, kw, stride)
    oh, ow = win.shape[2], win.shape[3]
    cols = win.permute(0, 1, 4, 5, 2, 3)
    if groups == 1:
        y = weight.reshape(o, -1) @ cols.reshape(n, c * kh * kw, oh * ow)
    else:
        cols = cols.reshape(n, groups, c // groups * kh * kw, oh * ow)
        y = weight.reshape(groups, o // groups, -1) @ cols
    y = y.reshape(n, o, oh * ow)
    if bias is not None:
        y = y + bias[:, None]
    return y.reshape(n, o, oh, ow)


def _conv_derivatives(fn, x, w, b, stride, pad, groups, gy):
    """The output, the first derivatives of (y . gy) and the gradient
    penalty's second derivative d|dx|^2 / dw of ``fn`` (dx = col2im(w^T gy),
    so its derivative runs im2col as col2im's backward)."""
    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    y = fn(x, w, b, stride, pad, groups)
    dx, dw, db = torch.autograd.grad((y * gy).sum(), (x, w, b), create_graph=True)
    (ddw,) = torch.autograd.grad(dx.square().sum(), w)
    return dict(y=y, dx=dx, dw=dw, db=db, ddw=ddw)


def columns_phase(card: str, rates):
    """Phase 12: the column kernels at the main shapes and the odd ones,
    bit for bit; their times; their launches in one train step."""
    import torch.nn.functional as F

    from stylex_tpu_torch.config import ModelConfig, TrainConfig
    from stylex_tpu_torch.device import set_float32_precision
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.ops import conv as tconv

    set_float32_precision()
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows, compared = [], []
    for group, cases in (("main", COLUMN_MAIN), ("extra", COLUMN_EXTRA)):
        for name, xs, ws, stride, pad, groups in cases:
            k, s, p = (ws[2], ws[3]), (stride, stride), (pad, pad)
            x = torch.randn(xs, generator=gen, device="cuda")
            w = torch.randn(ws, generator=gen, device="cuda") / float(np.sqrt(np.prod(ws[1:])))
            b = torch.randn(ws[0], generator=gen, device="cuda")
            # the kernels against their plain versions, alone: col2im from a
            # position-major gradient (an ungrouped GEMM's) and a row-major one
            # (a grouped GEMM's, which the wrapper copies position-major)
            reset_launches()
            cols = tconv.im2col(x, k, s, p)
            want = tconv.im2col_plain(x, k, s, p)
            g_rows = torch.randn(cols.shape, generator=gen, device="cuda")
            g = g_rows.mT.contiguous().mT
            dx = tconv.col2im(g, xs[2:], k, s, p)
            dx_want = tconv.col2im_plain(g, xs[2:], k, s, p)
            dx_rows = tconv.col2im(g_rows, xs[2:], k, s, p)
            torch.cuda.synchronize()
            alone = dict(im2col=torch.equal(cols, want),
                         col2im=torch.equal(dx, dx_want) and torch.equal(dx_rows, dx_want),
                         col2im_max_abs=float(torch.maximum((dx - dx_want).abs().max(),
                                                            (dx_rows - dx_want).abs().max())),
                         strides=list(cols.stride()),
                         launches=dict(im2col=LAUNCHES["im2col"], col2im=LAUNCHES["col2im"]))
            del want, dx_want, dx_rows, g_rows
            # the convolution through them against PR 2's, to second order
            y = tconv.conv2d_gemm(x, w, None, stride, pad, groups)
            gy = torch.randn(y.shape, generator=gen, device="cuda")
            del y
            got = _conv_derivatives(tconv.conv2d_gemm, x, w, b, stride, pad, groups, gy)
            got = {key: v.detach() for key, v in got.items()}
            ref = _conv_derivatives(_conv2d_gemm_autograd, x, w, b, stride, pad, groups, gy)
            ref = {key: v.detach() for key, v in ref.items()}
            torch.cuda.synchronize()
            equal = {key: torch.equal(got[key], ref[key]) for key in got}
            gaps = {key: float((got[key] - ref[key]).abs().max() / ref[key].abs().max().clamp_min(
                1e-30)) for key in got}
            row = dict(group=group, name=name, x=list(xs), w=list(ws), stride=stride,
                       padding=pad, groups=groups, alone=alone, equal=equal, gaps=gaps)
            del got, ref, gy
            log(f"  {name} x{xs} w{ws} s{stride} p{pad} g{groups}: im2col == plain "
                f"{alone['im2col']}, col2im == plain {alone['col2im']} "
                f"(max {alone['col2im_max_abs']:.3g}); conv against PR 2's, bit for bit: "
                + ", ".join(f"{key} {v}" for key, v in equal.items()) + f" [{card}]")
            if group == "main":  # times at the main shapes
                nbytes = 4 * (x.numel() + cols.numel())
                bound = nbytes / rates[0] * 1e3
                size = xs[2:]

                def plain_cols(t):  # the plain version, position-major too
                    return tconv.im2col_plain(t, k, s, p).mT.contiguous().mT

                with torch.no_grad():
                    row["im2col_ms"] = dict(
                        kernel=time_ms(lambda t: tconv.im2col(t, k, s, p), x),
                        device=device_ms(lambda t: tconv.im2col(t, k, s, p), x),
                        plain=time_ms(plain_cols, x),
                        library=time_ms(lambda t: F.unfold(t, k, 1, p, s), x), bound=bound)
                    row["col2im_ms"] = dict(
                        kernel=time_ms(lambda t: tconv.col2im(t, size, k, s, p), g),
                        device=device_ms(lambda t: tconv.col2im(t, size, k, s, p), g),
                        plain=time_ms(lambda t: tconv.col2im_plain(t, size, k, s, p), g),
                        library=time_ms(lambda t: F.fold(t, size, k, 1, p, s), g), bound=bound)
                for op in ("im2col", "col2im"):
                    t = row[f"{op}_ms"]
                    t["device_bound_share"] = t["bound"] / t["device"]
                    log(f"    {op}: kernel "
                        f"{t['kernel']:.4f} ms, device {t['device']:.4f} ms "
                        f"({t['device_bound_share']:.3f} of the bytes bound {t['bound']:.4f} ms, "
                        f"{nbytes / 1e9:.3f} GB), plain {t['plain']:.4f} ms, library "
                        f"{t['library']:.4f} ms [{card}]")
            rows.append(row)
            compared.append(all(equal.values()) and alone["im2col"] and alone["col2im"]
                            and alone["launches"] == dict(im2col=1, col2im=2))
            del x, w, b, cols, g, dx
            torch.cuda.empty_cache()

    # the train step launches both; no-grad and bfloat16 convolutions neither
    base = Path(tempfile.mkdtemp(prefix="stylex_columns_", dir=OUT_DIR))
    try:
        tc = TrainConfig(save_every=1000, evaluate_every=1000, num_image_tiles=4,
                         compute_dtype="float32")
        step, trainer = _train_run(card, base, "columns", ModelConfig(), tc, 1)
        del trainer
    finally:
        shutil.rmtree(base, ignore_errors=True)
    x = torch.randn(2, 8, 16, 16, device="cuda")
    w = torch.randn(8, 8, 3, 3, device="cuda", requires_grad=True)
    reset_launches()
    with torch.no_grad():
        tconv.conv2d(x, w, None, 1, 1)
    tconv.conv2d(x.bfloat16(), w.bfloat16(), None, 1, 1).float().sum().backward()
    torch.cuda.synchronize()
    bypass = dict(LAUNCHES)
    out = dict(rows=rows, train_step_launches=step["launches"], bypass_launches=bypass,
               train_step_ms=step["ms_per_step"])
    log(f"  one train step (CLI defaults, float32, GP): launches {step['launches']}; "
        f"no-grad and bfloat16 convolutions: im2col {bypass['im2col']}, col2im "
        f"{bypass['col2im']} [{card}]")
    if not all(compared):
        bad = [r["name"] for r, ok in zip(rows, compared) if not ok]
        raise AssertionError(f"column kernels differ from the plain path at {bad}")
    if step["launches"]["im2col"] <= 0 or step["launches"]["col2im"] <= 0:
        raise AssertionError(f"the train step did not launch both column kernels: "
                             f"{step['launches']}")
    if bypass["im2col"] or bypass["col2im"]:
        raise AssertionError(f"a no-grad or bfloat16 convolution launched a kernel: {bypass}")
    return out


def columns_summary(columns_out) -> dict:
    """The ``kernels`` line's timings of the column kernels: phase 12's
    float32 times summed over its main shapes (one call each), the largest
    gap to the plain version over every shape; no host cost measured."""
    rows = columns_out["rows"]
    main = [r for r in rows if r["group"] == "main"]
    out = {}
    for op in ("im2col", "col2im"):
        # im2col copies values (equal or not); col2im's largest gap
        err = (max(r["alone"]["col2im_max_abs"] for r in rows) if op == "col2im"
               else 0.0 if all(r["alone"]["im2col"] for r in rows) else float("nan"))
        out[op] = dict(max_abs_err=err, bound_by={"bytes"}, host_us=None, host_us_grad=None,
                       **{key: sum(r[f"{op}_ms"][part] for r in main) for key, part in (
                           ("ms", "kernel"), ("device_ms", "device"), ("plain_ms", "plain"),
                           ("bound_ms", "bound"), ("library_ms", "library"))})
    return out


# ------------------------------------------------------------------ phase 13

BN_BATCH = 512  # the sweep's chunk (coord_batch) in the 64- and 256-px cells


def batch_norm_calls(input_shape) -> list:
    """``(shape, relu6, residual)`` of every batch norm of one eval-mode
    MobileNetV2 forward over an input of ``input_shape``, in order: the
    shape it normalises, whether it applies ReLU6, whether it adds a
    residual. The network runs on the meta device: nothing is computed, at
    any size."""
    from stylex_tpu_torch.models.classifiers import FrozenBatchNorm2d, MobileNetV2

    with torch.device("meta"):
        net = MobileNetV2().eval()
    calls = []

    def record(module, args):
        residual = args[1] if len(args) > 1 else None
        calls.append((tuple(args[0].shape), module.act == "relu6", residual is not None))

    for m in net.modules():
        if isinstance(m, FrozenBatchNorm2d):
            m.register_forward_pre_hook(record)
    with torch.no_grad():
        net(torch.empty(input_shape, device="meta"))
    return calls


@contextlib.contextmanager
def _plain_batch_norm():
    """Every classifier batch norm on the plain chain: no tensor counts as
    lying where the kernel runs while the block runs."""
    from stylex_tpu_torch.ops import frozen_bn as fbn

    real = fbn.takes_kernel
    fbn.takes_kernel = lambda *_: False
    try:
        yield
    finally:
        fbn.takes_kernel = real


def _bn_counters(fn):
    """``fn()`` with spans and counters recorded: its result, the
    ``classifier.bn_fused`` and ``classifier.bn_plain`` counts and the
    ``frozen_bn`` launches."""
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.utils import tracing

    tracing.reset()
    reset_launches()
    with tracing.recording():
        out = fn()
    torch.cuda.synchronize()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    return out, dict(fused=counters.get("classifier.bn_fused", 0),
                     plain=counters.get("classifier.bn_plain", 0),
                     launches=LAUNCHES["frozen_bn"])


def _seeded_mobilenet(size: int, dtype, seed: int = 0):
    """A MobileNetV2 bundle on the card in ``dtype`` with running
    statistics, weights and biases of its batch norms drawn away from
    torchvision's 0 and 1."""
    from stylex_tpu_torch.models import build_classifier
    from stylex_tpu_torch.models.classifiers import FrozenBatchNorm2d

    clf = build_classifier("mobilenet", size, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for m in clf.net.modules():
            if isinstance(m, FrozenBatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen, device="cuda"))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(c, generator=gen, device="cuda"))
                m.weight.copy_(0.5 + torch.rand(c, generator=gen, device="cuda"))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen, device="cuda"))
    return clf.to(dtype)


def _bn_operands(shape, residual: bool, dtype, gen):
    """y, its residual or None, and the channels' mean, var, weight, scale
    (rsqrt(var + eps) * weight in ``dtype``, as the module computes it) and
    bias; y spread wide enough to reach both clamps."""
    c = shape[1]
    y = torch.randn(shape, generator=gen, device="cuda").mul_(3.0).to(dtype)
    res = torch.randn(shape, generator=gen, device="cuda").to(dtype) if residual else None
    mean, weight, bias = (torch.randn(c, generator=gen, device="cuda").to(dtype)
                          for _ in range(3))
    var = (torch.rand(c, generator=gen, device="cuda") + 0.25).to(dtype)
    return y, res, mean, var, weight, torch.rsqrt(var + 1e-5) * weight, bias


def batch_norm_phase(card: str, rates):
    """Phase 13: the classifiers' batch-norm kernel, float32 and bfloat16.
    (a) At every batch norm of MobileNetV2 at 512 x 256 px and 512 x 64 px
    (shape, ReLU6, residual as one forward hands them over): the kernel
    against the plain chain bit for bit; its ms by CUDA events around
    back-to-back calls, its device ms by a replayed CUDA graph, its host
    microseconds a call, and the device ms's share of the bytes bound (y
    and the residual read once, the output written once); the plain chain's
    and (float32) ``F.batch_norm``'s ms; NaN and infinities at two shapes.
    (b) One classifier forward on a sweep chunk at each size and dtype:
    logits on the fused path equal to the plain chain's bit for bit, 52
    fused layers and 52 launches against 52 plain ones, and both timed. (c)
    An AttFind sweep at the 64-px config in each dtype: every classifier
    forward fused (52 counted a forward, none plain), records equal to the
    plain chain's bit for bit. (d) One train step at the CLI defaults with
    MobileNetV2: its autograd forwards counted plain, its no-grad ones
    fused."""
    import torch.nn.functional as F

    from stylex_tpu_torch.ops import frozen_bn as fbn

    out = {}
    dtypes = (torch.float32, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(13)
    # (a) the kernel at every batch-norm shape
    rows = []
    for size in (256, 64):
        calls = batch_norm_calls((BN_BATCH, 3, size, size))
        reps = 5 if size == 256 else 20
        for dtype in dtypes:
            for shape, relu6, residual in sorted(set(calls), key=lambda c: -int(np.prod(c[0]))):
                y, res, mean, var, weight, scale, bias = _bn_operands(shape, residual, dtype, gen)
                got = fbn.frozen_bn(y, mean, scale, bias, res, relu6)
                want = fbn.frozen_bn_plain(y, mean, scale, bias, res, relu6)
                equal = torch.equal(got, want)
                err = 0.0 if equal else float((got.float() - want.float()).abs().max())
                del got, want
                torch.cuda.empty_cache()

                def kernel(t):
                    return fbn.frozen_bn(t, mean, scale, bias, res, relu6)

                def plain(t):
                    return fbn.frozen_bn_plain(t, mean, scale, bias, res, relu6)

                def library(t):
                    return F.batch_norm(t, mean, var, weight, bias, False, 0.0, 1e-5)

                bound = y.element_size() * y.numel() * (3 if residual else 2) / rates[0] * 1e3
                row = dict(size=size, dtype=str(dtype).split(".")[-1], shape=list(shape),
                           relu6=relu6, residual=residual,
                           layers=calls.count((shape, relu6, residual)), equal=equal,
                           max_abs_err=err, ms=time_ms(kernel, y, reps=reps, loops=3),
                           device_ms=device_ms(kernel, y, reps=reps, loops=3),
                           host_us=host_us(kernel, y, calls=50),
                           plain_ms=time_ms(plain, y, reps=reps, loops=3),
                           library_ms=(time_ms(library, y, reps=reps, loops=3)
                                       if dtype == torch.float32 else None),
                           bound_ms=bound)
                row["bound_share"] = bound / row["device_ms"]
                rows.append(row)
                library_ms = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
                log(f"  (a) {row['dtype']:8s} {str(shape):22s} relu6 {int(relu6)} residual "
                    f"{int(residual)} x{row['layers']}: bit for bit {equal} (max abs err "
                    f"{err:.3g}), ms {row['ms']:.4f}, device_ms {row['device_ms']:.4f} "
                    f"({row['bound_share']:.3f} of the bytes bound {bound:.4f} ms), host_us "
                    f"{row['host_us']:.2f}, plain {row['plain_ms']:.4f} ms, F.batch_norm "
                    f"{library_ms} ms [{card}]")
                del y, res
                torch.cuda.empty_cache()
    # NaN, infinities and a zero scale, at a ragged plane and an aligned one
    special = []
    for dtype in dtypes:
        for shape in ((64, 24, 7, 9), (64, 24, 8, 8)):
            y, res, mean, _, _, scale, bias = _bn_operands(shape, True, dtype, gen)
            y.view(-1)[::5] = float("nan")
            y.view(-1)[1::7] = float("inf")
            y.view(-1)[2::7] = -float("inf")
            res.view(-1)[3::11] = float("inf")
            scale[1] = 0.0
            for relu6 in (False, True):
                for r in (None, res):
                    got = fbn.frozen_bn(y, mean, scale, bias, r, relu6)
                    want = fbn.frozen_bn_plain(y, mean, scale, bias, r, relu6)
                    special.append(bool(torch.equal(got.isnan(), want.isnan()) and torch.equal(
                        got.nan_to_num(), want.nan_to_num())))
    out["kernel_rows"] = rows
    out["nan_inf_equal"] = all(special)
    log(f"  (a) NaN, +-inf, a zero scale: equal to the plain chain (NaN where it is NaN) "
        f"{all(special)} over {len(special)} cases [{card}]")

    # (b) one classifier forward on a sweep chunk, fused against plain
    forwards = {}
    for size in (256, 64):
        for dtype in dtypes:
            clf = _seeded_mobilenet(size, dtype)
            images = torch.rand(BN_BATCH, 3, size, size, generator=gen, device="cuda").to(dtype)
            with torch.no_grad():
                fused, fused_n = _bn_counters(lambda: clf.classify_images(images))
                with _plain_batch_norm():
                    plain, plain_n = _bn_counters(lambda: clf.classify_images(images))
                ms_fused = time_ms(clf.classify_images, images, reps=5, loops=3)
                with _plain_batch_norm():
                    ms_plain = time_ms(clf.classify_images, images, reps=5, loops=3)
            equal = torch.equal(fused, plain)
            label = f"{size}_{str(dtype).split('.')[-1]}"
            forwards[label] = dict(equal=equal, fused=fused_n, plain=plain_n, ms_fused=ms_fused,
                                   ms_plain=ms_plain)
            log(f"  (b) MobileNetV2 forward, {BN_BATCH} x {size} px, {dtype}: logits fused == "
                f"plain {equal}; fused path {fused_n}, plain path {plain_n}; {ms_fused:.3f} ms "
                f"fused, {ms_plain:.3f} ms plain [{card}]")
            del clf, images
            torch.cuda.empty_cache()
    out["forwards"] = forwards

    # (c) a sweep: every classifier forward fused, the records as the plain chain's
    from stylex_tpu_torch.attfind import attfind_extraction
    from stylex_tpu_torch.config import ModelConfig
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.models import build_stylex
    from stylex_tpu_torch.ops.latents import image_noise

    cfg = ModelConfig()
    ds = SyntheticImageDataset(2, cfg.image_size)
    images = np.stack([ds[i] for i in range(2)])
    noise = image_noise(torch.Generator().manual_seed(42), 1, cfg.image_size).numpy()
    sweeps = {}
    for dtype in dtypes:
        model = build_stylex(cfg, seed=0, device="cuda").to(dtype)
        clf = _seeded_mobilenet(cfg.image_size, dtype)
        n_forwards = [0]

        def classify(x):
            n_forwards[0] += 1
            return clf.classify_images(x)

        def sweep():
            return attfind_extraction(model, classify, images, noise, coord_batch=BN_BATCH,
                                      compute_dtype=dtype, progress=False)

        sweep()  # warm-up
        n_forwards[0] = 0
        rec, sweep_n = _bn_counters(sweep)
        calls = n_forwards[0]
        with _plain_batch_norm():
            rec_plain, sweep_plain_n = _bn_counters(sweep)
        same = all(np.array_equal(getattr(rec, f), getattr(rec_plain, f), equal_nan=True)
                   for f in ("style_change", "base_prob", "latents", "style_coordinates",
                             "discriminator"))
        label = str(dtype).split(".")[-1]
        sweeps[label] = dict(classifier_forwards=calls, counters=sweep_n,
                             counters_plain=sweep_plain_n, records_equal=same)
        log(f"  (c) sweep, 64 px, 2 images, {dtype}: {calls} classifier forwards, counters "
            f"{sweep_n} (plain chain forced: {sweep_plain_n}); records equal bit for bit "
            f"{same} [{card}]")
        del model, clf, rec, rec_plain
        torch.cuda.empty_cache()
    out["sweeps"] = sweeps

    # (d) one train step: autograd forwards plain, no-grad forwards fused
    from stylex_tpu_torch.config import TrainConfig
    from stylex_tpu_torch.train.trainer import Trainer

    base = Path(tempfile.mkdtemp(prefix="stylex_bn_", dir=OUT_DIR))
    try:
        tc = TrainConfig(save_every=1000, evaluate_every=1000, num_image_tiles=4,
                         compute_dtype="float32")
        trainer = Trainer(name="smoke-bn", base_dir=str(base), model_cfg=ModelConfig(),
                          train_cfg=tc, classifier_name="mobilenet", seed=0)
        try:
            trainer.set_data_src(dataset_name="synthetic")
            trainer.init_stylex()
            trainer.train()  # the first step: saves, evaluation, allocations

            def step():
                trainer.train()
                trainer.flush()

            _, step_n = _bn_counters(step)
        finally:
            trainer.close()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["train_step"] = step_n
    log(f"  (d) one train step (CLI defaults, float32, MobileNetV2): {step_n} [{card}]")

    head = max((r for r in rows if r["dtype"] == "float32"), key=lambda r: np.prod(r["shape"]))
    out["headline"] = head
    log(f"  headline float32 {head['shape']}: device_ms {head['device_ms']:.4f}, "
        f"{head['bound_share']:.3f} of the bytes bound [{card}]")
    bad = [(r["dtype"], r["shape"]) for r in rows if not r["equal"]]
    if bad or not out["nan_inf_equal"]:
        raise AssertionError(f"batch-norm kernel differs from the plain chain at {bad}, "
                             f"NaN/inf cases equal {out['nan_inf_equal']}")
    for label, f in forwards.items():
        if not f["equal"] or f["fused"] != dict(fused=52, plain=0, launches=52) or \
                f["plain"] != dict(fused=0, plain=52, launches=0):
            raise AssertionError(f"classifier forward at {label}: {f}")
    for label, s in sweeps.items():
        n = s["classifier_forwards"]
        if not s["records_equal"] or s["counters"] != dict(fused=52 * n, plain=0,
                                                           launches=52 * n):
            raise AssertionError(f"{label} sweep: {s}")
    if not step_n["plain"] or not step_n["fused"] or step_n["plain"] % 52 or \
            step_n["fused"] % 52 or step_n["launches"] != step_n["fused"]:
        raise AssertionError(f"train step batch norms: {step_n}")
    return out


def batch_norm_summary(bn_out) -> dict:
    """The ``kernels`` line's timings of the batch-norm kernel: phase 13's
    float32 sums over one MobileNetV2 forward's batch norms at 512 x 256 px
    (each shape times its layers), and the median host microseconds a call
    over every shape and dtype; it never runs under autograd."""
    rows = bn_out["kernel_rows"]
    main = [r for r in rows if r["size"] == 256 and r["dtype"] == "float32"]
    sums = {key: sum(r[key] * r["layers"] for r in main)
            for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}
    return {"frozen_bn": dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                              bound_by={"bytes"},
                              host_us=statistics.median(r["host_us"] for r in rows),
                              host_us_grad=None, **sums)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-2 only; rows to chip_smoke_kernels[_TAG].json in the "
                         "output directory")
    ap.add_argument("--package-root", default=str(ROOT),
                    help="import stylex_tpu_torch from this checkout (to time another commit's "
                         "kernels with this script's phase 2)")
    ap.add_argument("--tag", default="", help="suffix of the --kernels-only output file")
    ap.add_argument("--conv-only", action="store_true",
                    help="phases 1 and 12 only; details to chip_smoke_conv.json")
    ap.add_argument("--bn-only", action="store_true",
                    help="phases 1 and 13 only; details to chip_smoke_bn.json")
    ap.add_argument("--google-only", action="store_true",
                    help="phases 1, 2 and 10 only; details to chip_smoke_google.json")
    ap.add_argument("--parallel-only", action="store_true",
                    help="phases 1 and 11 only; details to chip_smoke_parallel.json")
    ap.add_argument("--cards", type=int, default=1,
                    help="with --parallel-only: also run phase 11 on this many cards, one rank "
                         "each (NCCL)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    from stylex_tpu_torch import csrc

    OUT_DIR.mkdir(exist_ok=True)

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    rates = peak_rates(kind)
    log(f"[phase 1] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"bounds from {rates[0] / 1e12} TB/s and {rates[1] / 1e12} float32 TFLOP/s")
    t = time.perf_counter()
    paths = csrc.build(verbose=True)
    log(f"  built {sorted(paths)} in {time.perf_counter() - t:.2f} s")

    if args.conv_only:
        log("[phase 12] the convolution's column kernels")
        conv_out = columns_phase(card, rates)
        (OUT_DIR / "chip_smoke_conv.json").write_text(json.dumps(
            dict(card=card, kind=kind, columns=conv_out), indent=1, default=str))
        log(card)
        return 0

    if args.bn_only:
        log("[phase 13] the classifiers' batch-norm kernel")
        bn_out = batch_norm_phase(card, rates)
        (OUT_DIR / "chip_smoke_bn.json").write_text(json.dumps(
            dict(card=card, kind=kind, batch_norm=bn_out), indent=1, default=str))
        log(card)
        return 0

    if args.parallel_only:
        log("[phase 11] data parallelism on the one card")
        parallel_out = parallel_phase(card, args.cards)
        (OUT_DIR / "chip_smoke_parallel.json").write_text(json.dumps(
            dict(card=card, kind=kind, parallel=parallel_out), indent=1, default=str))
        log(card)
        return 0

    log("[phase 2] kernels against their plain versions")
    rows, summary, host_parts = kernel_phase(card, rates)
    if args.kernels_only:
        for s in summary.values():
            s["bound_by"] = "+".join(sorted(s["bound_by"]))
        out = OUT_DIR / f"chip_smoke_kernels{'_' + args.tag if args.tag else ''}.json"
        out.write_text(json.dumps(dict(card=card, kind=kind, package_root=args.package_root,
                                       kernel_rows=rows, summary=summary,
                                       host_breakdown_us=host_parts), indent=1))
        log(card)
        print(json.dumps({"summary": summary}), flush=True)
        return 0
    if args.google_only:
        log("[phase 10] Google's generator at 256 px, its counterfactual FID, the dispatch "
            "knobs, the chunked sweep, the host utilities, the 256-px sweeps' upsample")
        google_out = google_phase(card, summary, rates)
        (OUT_DIR / "chip_smoke_google.json").write_text(json.dumps(
            dict(card=card, kind=kind, google=google_out), indent=1, default=str))
        log(card)
        return 0

    log("[phase 3] main path: AttFind extraction, 64px, bf16, full width")
    main_out, checks, ranked, f32_run = main_path_phase(card)

    log("[phase 4] card against CPU, float32, TF32 off")
    cpu_errs = card_vs_cpu_phase()

    log("[phase 5] training path: Trainer.train() at the CLI defaults, full width")
    train_out, f32_trainer = training_phase(card)

    log("[phase 6] card against CPU and a float64 witness: convolutions, then one train step, "
        "full width, float32, TF32 off")
    conv_rows = conv_precision()
    train_cpu_errs = train_card_vs_cpu_phase()

    log("[phase 7] model and step options at full width: attention, no_const, fq_layers, "
        "cl_reg, the scan step")
    options_out = options_phase(card)

    log("[phase 8] evaluation: Inception, the counterfactual protocol, training with FID, "
        "the replay and user-study CLIs; float32, TF32 off")
    eval_out, cf_run = evaluation_phase(card, f32_run)

    log("[phase 9] weights in and out: the JAX checkpoint format, an inference load and "
        "run_attfind --name, .msgpack trees, classifier pretraining, the counterfactual runner")
    t9 = time.perf_counter()
    weights_out = weights_phase(card, f32_trainer, f32_run, cf_run)
    weights_out["seconds"] = time.perf_counter() - t9
    log(f"  phase 9 took {weights_out['seconds']:.1f} s [{card}]")

    log("[phase 10] Google's generator at 256 px, its counterfactual FID, the dispatch knobs, "
        "the chunked sweep, the host utilities, the 256-px sweeps' upsample")
    t10 = time.perf_counter()
    google_out = google_phase(card, summary, rates)
    google_out["seconds"] = time.perf_counter() - t10
    log(f"  phase 10 took {google_out['seconds']:.1f} s [{card}]")

    log("[phase 11] data parallelism on the one card: the trainer as one process, a group of "
        "one (NCCL) and two ranks (gloo); run_attfind on two ranks")
    t11 = time.perf_counter()
    parallel_out = parallel_phase(card)
    parallel_out["seconds"] = time.perf_counter() - t11
    log(f"  phase 11 took {parallel_out['seconds']:.1f} s [{card}]")

    log("[phase 12] the convolution's column kernels: bit for bit at the main shapes, times, "
        "their launches in a train step")
    t12 = time.perf_counter()
    columns_out = columns_phase(card, rates)
    columns_out["seconds"] = time.perf_counter() - t12
    log(f"  phase 12 took {columns_out['seconds']:.1f} s [{card}]")

    log("[phase 13] the classifiers' batch-norm kernel: bit for bit at MobileNetV2's shapes, "
        "times, a classifier forward, a sweep and a train step on each path")
    t13 = time.perf_counter()
    bn_out = batch_norm_phase(card, rates)
    bn_out["seconds"] = time.perf_counter() - t13
    log(f"  phase 13 took {bn_out['seconds']:.1f} s [{card}]")

    sources = {"upsample2x_bilinear": "stylex_tpu_torch/csrc/upsample2x_bilinear.cu",
               "blur3": "stylex_tpu_torch/csrc/blur3.cu",
               "blur3_downsample2x": "stylex_tpu_torch/csrc/blur3.cu",
               "im2col": "stylex_tpu_torch/csrc/im2col.cu",
               "col2im": "stylex_tpu_torch/csrc/col2im.cu",
               "frozen_bn": "stylex_tpu_torch/csrc/frozen_bn.cu"}
    replaces = {"upsample2x_bilinear": "stylex_tpu/ops/pallas_upsample.py:159",
                "blur3": "stylex_tpu/ops/pallas_blur.py:122",
                "blur3_downsample2x": "stylex_tpu/ops/pallas_blur.py:128",
                "im2col": "none", "col2im": "none", "frozen_bn": "none"}
    timings = {**summary, **columns_summary(columns_out), **batch_norm_summary(bn_out)}
    kernels = [
        dict(name=name, route="cuda", source=sources[name], replaces=replaces[name],
             launches=main_out["resume"]["launches"][name],
             launches_flat=main_out["flat"]["launches"][name],
             launches_train=train_out["float32"]["launches"][name],
             launches_train_literal=train_out["float32_literal"]["launches"][name],
             launches_train_bf16=train_out["bfloat16"]["launches"][name],
             launches_options=options_out["launches"][name],
             launches_eval=eval_out["counterfactual"]["launches"][name],
             launches_eval_train=eval_out["training"]["launches"][name],
             launches_eval_clis=eval_out["clis"]["launches"][name],
             launches_weights=weights_out["full_load"]["launches"][name]
             + weights_out["inference_load"]["launches"][name],
             launches_weights_step=weights_out["full_load"]["launches"][name],
             launches_weights_attfind=weights_out["inference_load"]["launches"][name],
             launches_google256=google_out["generator"]["launches_fused"][name],
             launches_google256_literal=google_out["generator"]["launches_literal"][name],
             launches_google_fid=google_out["fid_topk"]["launches"][name],
             launches_google_sweep=google_out["sweeps"]["google256.latent_attfind"]["launches"][
                 name],
             launches_ffhq256_sweep=google_out["sweeps"]["ffhq256.attfind"]["launches"][name],
             launches_dispatch_blocks=google_out["dispatch"]["blocks"]["launches"][name],
             launches_chunked_sweep=google_out["chunked_sweep"]["run1_k8"]["launches"][name],
             launches_parallel_train=sum(
                 r[name] for r in parallel_out["train"]["gloo_2"]["launches"]),
             launches_parallel_sweep=sum(
                 r[name] for r in parallel_out["sweep"]["gloo_2"]["launches"]),
             gen256=s.get("gen256_float32"), gen256_bf16=s.get("gen256_bfloat16"),
             max_abs_err=s["max_abs_err"], ms=s["ms"], device_ms=s["device_ms"],
             plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
             bound_by="+".join(sorted(s["bound_by"])), library_ms=s["library_ms"],
             host_us=s["host_us"], host_us_grad=s["host_us_grad"])
        for name, s in timings.items()
    ]
    detail = dict(
        card=card, kind=kind, torch=torch.__version__, cuda=torch.version.cuda,
        kernel_rows=rows, kernels=kernels, host_breakdown_us=host_parts,
        main_path={k: {kk: vv for kk, vv in v.items() if kk != "records"}
                   for k, v in main_out.items()},
        main_path_checks=checks, ranked=ranked,
        card_vs_cpu=cpu_errs, training=train_out, conv_precision=conv_rows,
        train_card_vs_cpu=train_cpu_errs, options=options_out, evaluation=eval_out,
        weights=weights_out, google=google_out, parallel=parallel_out, columns=columns_out,
        batch_norm=bn_out, seconds=time.perf_counter() - t_start,
    )
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(f"done in {detail['seconds']:.1f} s; kernel ms, device_ms, plain_ms, library_ms and "
        f"bound_ms are bf16 sums over one sweep chunk's calls (blur3_downsample2x: over the D/E "
        f"shapes of one 32-image training phase); host_us and host_us_grad the median host cost "
        f"per wrapper call over every phase-2 shape, without and with autograd; launches from "
        f"the block-resume run, launches_train from the 6 float32 training steps on the fused "
        f"graph (launches_train_literal on the literal one), launches_options from phase 7, "
        f"launches_eval from phase 8's counterfactual step (launches_eval_train from its training "
        f"with FID, launches_eval_clis from its replay and user-study CLIs), launches_weights "
        f"from phase 9: (a) the two train steps from the saved and the loaded trainer "
        f"(launches_weights_step) plus (b) run_attfind on the inference load "
        f"(launches_weights_attfind); launches_google256 from one forward of Google's 256-px "
        f"generator at batch 8 on the fused graph (_literal on the literal one), "
        f"launches_google_fid from phase 10 (b), launches_google_sweep and "
        f"launches_ffhq256_sweep from (f)'s float32 sweeps at the 256-px cells' parameters, "
        f"launches_dispatch_blocks from (c)'s 7 steps in blocks of 4, launches_chunked_sweep from (d)'s run_attfind --chunks-per-dispatch 8, "
        f"launches_parallel_train and launches_parallel_sweep from phase 11's two ranks "
        f"(summed over both) of (a) 5 train steps and (b) run_attfind; "
        f"gen256 (float32) and gen256_bf16 sum phase 2's times over one literal-graph forward's "
        f"upsample calls at 256 px; for im2col and col2im the times are float32 sums over phase "
        f"12's main shapes, one call each, and host_us was not measured; for frozen_bn they "
        f"are float32 sums over one MobileNetV2 forward's batch norms at 512 x 256 px (phase "
        f"13), host_us the median over its shapes and dtypes, host_us_grad none (it never "
        f"runs under autograd)")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
