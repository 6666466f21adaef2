"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Device and build: needs CUDA; prints the card's name and power limit;
   builds every CUDA kernel of the package from its sources.
2. Each kernel against its plain PyTorch version on the card, float32 and
   bfloat16, at the shapes the AttFind main path gives it (plus one
   256px-scale upsample): max abs error against the stated tolerance, and
   CUDA-event times of the kernel, the plain version and the one-call
   PyTorch yardstick, beside the least time the card's memory and float32
   arithmetic rates allow.
3. The main path at full width: AttFind extraction at the 64px config
   (2464 StyleSpace coordinates, MobileNetV2 classifier, random weights from
   a seed), bfloat16, 4 images, ``coord_batch=616``; the block-resume sweep,
   then the flat sweep. Each run starts with the launch counts at 0 and must
   launch every kernel; the two agree to a stated bf16 bound. Both sweeps
   then run in float32, where they must agree closely.
4. The card against the CPU: phase 1 for 2 images and one 32-element sweep
   chunk, float32 with TF32 off, the same weights on both.

It prints a ``kernels`` JSON line and, last, the ``ok`` JSON line. Details
go to ``chiprun_out/chip_smoke.json``.
"""

import json
import statistics
import subprocess
import sys
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
    """Median over ``loops`` of the CUDA-event time of ``reps`` calls / reps."""
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


def bf16_ulp(magnitude: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(magnitude, 1e-30))) - 7)


# ------------------------------------------------------------------ phase 2


def kernel_phase(card: str, rates):
    import torch.nn.functional as F

    from stylex_tpu_torch.ops import blur as ops

    b = COORD_BATCH
    up_shapes = [(b, 512, 4, 4), (b, 256, 8, 8), (b, 128, 16, 16), (b, 64, 32, 32),
                 (b, 3, 4, 4), (b, 3, 8, 8), (b, 3, 16, 16), (b, 3, 32, 32)]
    blur_shapes = [(b, 3, 8, 8), (b, 3, 16, 16), (b, 3, 32, 32), (b, 3, 64, 64)]
    # D/E pre-blur in phase 1 (4 images per phase-1 batch)
    blur_phase1 = [(N_IMAGES, 64, 64, 64), (N_IMAGES, 128, 32, 32), (N_IMAGES, 256, 16, 16),
                   (N_IMAGES, 512, 8, 8), (N_IMAGES, 512, 4, 4)]
    up_256px = [(4, 64, 128, 128)]

    def blur_library(x):
        k = x.new_tensor([1.0, 2.0, 1.0])
        k = (k[:, None] * k[None, :] / 16.0).expand(x.shape[1], 1, 3, 3)
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k, groups=x.shape[1])

    specs = {
        "upsample2x_bilinear": dict(
            wrapper=ops.upsample2x_bilinear, plain=ops.upsample2x_bilinear_plain,
            library=lambda x: F.interpolate(x, scale_factor=2, mode="bilinear",
                                            align_corners=False),
            # read x, write 4x; 3 two-tap sums (2 mul + 1 add) per output
            bytes_per_in=5, flops_per_in=4 * 9, chunk=up_shapes, extra=up_256px),
        "blur3": dict(
            wrapper=ops.blur3, plain=ops.blur3_plain, library=blur_library,
            # read x, write x; 4 three-tap sums (3 mul + 2 add) per output
            bytes_per_in=2, flops_per_in=4 * 5, chunk=blur_shapes, extra=blur_phase1),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, summary = [], {}
    for name, sp in specs.items():
        summary[name] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                             library_ms=0.0, bound_by=set())
        for dtype in (torch.float32, torch.bfloat16):
            for shape in sp["chunk"] + sp["extra"]:
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
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
                row = dict(kernel=name, dtype=str(dtype).split(".")[-1], shape=list(shape),
                           max_abs_err=err, tol=tol, ok=ok,
                           ms=time_ms(sp["wrapper"], x), plain_ms=time_ms(sp["plain"], x),
                           library_ms=time_ms(sp["library"], x), bound_ms=bound,
                           bound_by=bound_by,
                           on_chunk=shape in sp["chunk"])
                rows.append(row)
                log(f"  {name:20s} {row['dtype']:8s} {str(tuple(shape)):22s} err={err:.3g} "
                    f"(tol {tol:.3g}) ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                    f"library={row['library_ms']:.4f} bound={bound:.4f} ({bound_by}) [{card}]")
                if not ok:
                    raise AssertionError(f"{name} {row['dtype']} {shape}: error {err} > {tol}")
                s = summary[name]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                if row["on_chunk"] and dtype == torch.bfloat16:
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                        s[key] += row[key]
                    s["bound_by"].add(bound_by)
    return rows, summary


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
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"{label}: kernel {name} was not launched on the main path")

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
    return out, checks, ranked


# ------------------------------------------------------------------ phase 4


def card_vs_cpu_phase():
    from stylex_tpu_torch.attfind.extraction import _phase1, _sweep_chunk
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
            w, coords, d, base, _ = _phase1(model, clf.classify_images, x, nz, False)
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


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(ROOT))
    from stylex_tpu_torch import csrc

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    rates = peak_rates(kind)
    log(f"[phase 1] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"bounds from {rates[0] / 1e12} TB/s and {rates[1] / 1e12} float32 TFLOP/s")
    t = time.perf_counter()
    paths = csrc.build(verbose=True)
    log(f"  built {sorted(paths)} in {time.perf_counter() - t:.2f} s")

    log("[phase 2] kernels against their plain versions")
    rows, summary = kernel_phase(card, rates)

    log("[phase 3] main path: AttFind extraction, 64px, bf16, full width")
    main_out, checks, ranked = main_path_phase(card)

    log("[phase 4] card against CPU, float32, TF32 off")
    cpu_errs = card_vs_cpu_phase()

    sources = {"upsample2x_bilinear": "stylex_tpu_torch/csrc/upsample2x_bilinear.cu",
               "blur3": "stylex_tpu_torch/csrc/blur3.cu"}
    replaces = {"upsample2x_bilinear": "stylex_tpu/ops/pallas_upsample.py:158",
                "blur3": "stylex_tpu/ops/pallas_blur.py:121"}
    kernels = [
        dict(name=name, route="cuda", source=sources[name], replaces=replaces[name],
             launches=main_out["resume"]["launches"][name],
             launches_flat=main_out["flat"]["launches"][name],
             max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
             bound_ms=s["bound_ms"], bound_by="+".join(sorted(s["bound_by"])),
             library_ms=s["library_ms"])
        for name, s in summary.items()
    ]
    OUT_DIR.mkdir(exist_ok=True)
    detail = dict(
        card=card, kind=kind, torch=torch.__version__, cuda=torch.version.cuda,
        kernel_rows=rows, kernels=kernels,
        main_path={k: {kk: vv for kk, vv in v.items() if kk != "records"}
                   for k, v in main_out.items()},
        main_path_checks=checks, ranked=ranked,
        card_vs_cpu=cpu_errs, seconds=time.perf_counter() - t_start,
    )
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    log(f"done in {detail['seconds']:.1f} s; kernel ms, plain_ms, library_ms and bound_ms are "
        f"sums over one bf16 sweep chunk's calls; launches from the block-resume run")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
