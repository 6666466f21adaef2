"""AttFind traffic: back-to-back ``attfind_extraction`` calls, as
``run_attfind`` makes them, over seeded image sets.

Set-up makes the weights of StylEx and the classifier on the device from
the seed, ``sets`` image sets of ``images_per_call`` images and the fixed
noise image, builds the program's model and classifier with those
weights, and runs one whole call on the first set (every shape of the
window, the kernels built and loaded). The window runs calls on the next
sets, cycling, until ``--seconds`` have passed; the last call runs to its
end. With ``--trace 1`` the window's first call is traced whole.

After the window the program's model is freed and the plain reference
recomputes phase 1 of every call's images and a sample of each call's
perturbations (drawn from the seed, the same number from every generator
block), and compares them with the records.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common
from benchmark.counters import work
from benchmark.reference import attfind as ref_attfind
from benchmark.reference import nets, ops

PRECISION = "float32"  # the sweep's, with TF32 off, as run_attfind runs it by default


def _program(c: dict, clf_kind: str, weights: dict, device):
    """The program's StylEx and classifier with the benchmark's weights."""
    from stylex_tpu_torch.config import Arch, ModelConfig
    from stylex_tpu_torch.models.classifiers import ClassifierBundle, MobileNetV2, ResNet18
    from stylex_tpu_torch.models.stylex import StylEx

    cfg = ModelConfig(**{k: v for k, v in c.items() if k in common.MODEL_KEYS},
                      arch=Arch(c["arch"]))
    with torch.device("meta"):
        model = StylEx(cfg)
        net = ResNet18(c["num_classes"]) if clf_kind == "resnet" else MobileNetV2(c["num_classes"])
    model = model.to_empty(device=device)
    model.load_state_dict(common.split(weights, "stylex"))
    net = net.to_empty(device=device)
    net.load_state_dict(common.split(weights, "classifier"))
    bundle = ClassifierBundle(clf_kind, net, c["image_size"], num_classes=c["num_classes"])
    return model.eval(), bundle


def _reference(c: dict, clf_kind: str, weights: dict, device):
    model = nets.StylEx(c).to(device)
    model.load_state_dict(common.split(weights, "stylex"))
    clf = nets.Classifier(clf_kind, c["image_size"], c["num_classes"]).to(device)
    clf.net.load_state_dict(common.split(weights, "classifier"))
    return model.eval(), clf.eval()


def make_inputs(c: dict, p: dict, seed: int, device):
    """The image sets (host float32 NHWC, as ``run_attfind`` passes them)
    and the noise image, from the seed."""
    gen = torch.Generator(device=device).manual_seed((int(seed) + 1) % (2 ** 63))
    S = c["image_size"]
    imgs = common.smooth_images(gen, p["sets"] * p["images_per_call"], S, device)
    imgs = imgs.permute(0, 2, 3, 1).cpu().numpy().reshape(p["sets"], p["images_per_call"], S, S, 3)
    noise = torch.rand(1, S, S, 1, generator=gen, device=device).cpu().numpy()
    return imgs, noise


def sample_ids(c: dict, n_images: int, per_block: int, seed: int, call: int):
    """(image, direction, coordinate) of the perturbations compared in
    window call ``call``: ``per_block`` from every generator block."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), call])
    out, offset = [], 0
    for size in work.block_sizes(c):
        n = min(per_block, 2 * n_images * size)
        flat = rng.choice(2 * n_images * size, size=n, replace=False)
        img, rest = np.divmod(flat, 2 * size)
        direction, coord = np.divmod(rest, size)
        out.append(np.stack([img, direction, coord + offset], axis=1))
        offset += size
    return np.concatenate(out)


def reference_outputs(c: dict, clf_kind: str, weights: dict, device, calls: list, noise,
                      p: dict, seed: int, precision: str = "float32", fault=None) -> list:
    """Per compared call, the reference's phase 1 of its images and the
    logit changes of its sampled perturbations, computed at ``precision``:
    dicts of ``latents``, ``coords``, ``d``, ``base``, ``effects``,
    ``ids``. ``fault="next_coordinate"`` perturbs each sampled
    perturbation's next coordinate: an answer altered where it is made."""
    model, clf = _reference(c, clf_kind, weights, device)
    noise_t = torch.from_numpy(noise).to(device)
    out = []
    with ops.precision(precision):
        for i, images in enumerate(calls):
            x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2))).to(device)
            w, coords, d, base = ref_attfind.phase1(model, clf, x, noise_t)
            ids = sample_ids(c, x.shape[0], p["compare_per_block"], seed, i)
            t = torch.from_numpy(ids).to(device)
            coord = t[:, 2]
            if fault == "next_coordinate":
                coord = (coord + 1) % coords.shape[1]
            eff = ref_attfind.effects(model, clf, w, coords, base, noise_t, t[:, 0], coord,
                                      t[:, 1] == 1, p["shift_size"])
            out.append(dict(latents=w.cpu(), coords=coords.cpu(), d=d.cpu(), base=base.cpu(),
                            effects=eff.cpu(), ids=ids))
    del model, clf
    common.free_device_memory()
    return out


def program_outputs(records, ref: list) -> list:
    """The same quantities read from the program's records."""
    out = []
    for rec, r in zip(records, ref):
        ids = r["ids"]
        out.append(dict(latents=torch.from_numpy(rec.latents),
                        coords=torch.from_numpy(rec.style_coordinates),
                        d=torch.from_numpy(rec.discriminator[:, 0]),
                        base=torch.from_numpy(rec.base_prob),
                        effects=torch.from_numpy(
                            rec.style_change[ids[:, 0], ids[:, 1], ids[:, 2]])))
    return out


def gaps(prog: list, ref: list) -> dict:
    """``phase1_gap``: the worst of max |diff| / max |reference| over w,
    the style coordinates, the D score and the base logits of every
    compared call; ``effect_gap``: max |diff| of the sampled logit
    changes over max |reference perturbed logits|."""
    detail = {k: 0.0 for k in ("latents", "coords", "d", "base", "effect_rel_effects")}
    effect = 0.0
    for a, b in zip(prog, ref):
        for k in ("latents", "coords", "d", "base"):
            detail[k] = max(detail[k], common.relative_gap(a[k], b[k]))
        scale = (b["effects"] + b["base"][b["ids"][:, 0]]).abs().max().item()
        diff = (a["effects"].double() - b["effects"].double()).abs().max().item()
        effect = max(effect, diff / max(scale, 1e-30))
        detail["effect_rel_effects"] = max(detail["effect_rel_effects"],
                                           common.relative_gap(a["effects"], b["effects"]))
    phase1 = max(detail[k] for k in ("latents", "coords", "d", "base"))
    return {"phase1_gap": phase1, "effect_gap": effect, "detail": detail}


def run(ctx) -> dict:
    from stylex_tpu_torch.attfind.extraction import attfind_extraction

    c, p, device, seed = ctx.config["model"], ctx.workload["params"], ctx.device, ctx.seed
    clf_kind = p["classifier"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = common.make_weights(common.reference_shapes(c, clf_kind, False), seed, device)
    model, clf = _program(c, clf_kind, weights, device)
    image_sets, noise = make_inputs(c, p, seed, device)

    def call(images):
        return attfind_extraction(
            model, clf.classify_images, images, noise, shift_size=p["shift_size"],
            coord_batch=p["coord_batch"], block_resume=True,
            compute_dtype=getattr(torch, PRECISION),
            chunks_per_dispatch=p["chunks_per_dispatch"], progress=False)

    call(image_sets[0])  # warm-up: every shape of the window
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = common.since_process_start()

    calls, walls = [], []
    trace = None
    t0 = time.perf_counter()
    i = 0
    while True:
        images = image_sets[(i + 1) % p["sets"]]
        if ctx.trace and i == 0:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
            ts = time.perf_counter()
            with profile(activities=activities) as prof:
                rec = call(images)
            traced_s = time.perf_counter() - ts
        else:
            ts = time.perf_counter()
            rec = call(images)
        walls.append(time.perf_counter() - ts)
        calls.append((images, rec))
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if ctx.trace:
        from benchmark import trace_summary

        trace = trace_summary.summarize(prof, traced_s)
        del prof
    n_img = p["images_per_call"]
    styles = [r.style_change.shape[0] * 2 * r.style_change.shape[2] for _, r in calls]
    stage = [r.stage_walls for _, r in calls]

    failed = sum(int((~np.isfinite(r.style_change)).any(axis=3).sum()) for _, r in calls)
    records = [r for _, r in calls]
    del model, clf
    common.free_device_memory()
    ref = reference_outputs(c, clf_kind, weights, device, [im for im, _ in calls], noise, p, seed)
    result = gaps(program_outputs(records, ref), ref)
    control = None
    if ctx.control:
        low = reference_outputs(c, clf_kind, weights, device, [im for im, _ in calls], noise, p,
                                seed, ops.control_for(PRECISION))
        control = gaps(low, ref)
        shifted = reference_outputs(c, clf_kind, weights, device, [im for im, _ in calls], noise,
                                    p, seed, fault="next_coordinate")
        control["fault_next_coordinate"] = {k: v for k, v in gaps(shifted, ref).items()
                                            if k != "detail"}
    counts = work.attfind_call(c, clf_kind, n_img) if ctx.trace else None
    return dict(
        kind="attfind", setup_s=setup_s, window_s=window_s, memory_peak_bytes=peak,
        styles=sum(styles), call_walls=walls, call_styles=styles, stage_walls=stage,
        chunks_per_call=work.chunks_per_call(c, n_img, p["coord_batch"]),
        trace=trace, counts=counts, traced_calls=1 if ctx.trace else 0,
        checks=[(k, result[k], limit) for k, limit in p["limits"].items()],
        attempted=sum(styles), failed=failed, control=control, detail=result["detail"],
        numbers={k: v for k, v in result.items() if k != "detail"},
        notes=dict(call_walls=walls, device_s_by_kind=trace and trace["kind_s"]),
        peak_flops=common.PEAK_FLOPS["float32"],
    )
