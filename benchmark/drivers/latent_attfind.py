"""AttFind on Google's published StylEx generator from dlatents:
back-to-back ``attfind_extraction`` calls, as ``run_attfind
--google-generator`` makes them, over seeded dlatents.

Set-up makes the generator's and the classifier's weights on the device
from the seed, a pool of ``pool`` seeded dlatents (512 normal dims and a
one-hot class), the range of every StyleSpace coordinate over the pool
(the notebook's extremes), builds the program's generator and classifier
with those weights, and runs one whole call on the first set (every shape
of the window, the kernels built and loaded). The window's calls take the
pool's first ``sets`` sets of ``dlatents_per_call`` dlatents, cycling,
until ``--seconds`` have passed; the last call runs to its end. With
``--trace 1`` the window's first call is traced whole.

After the window the program is freed and the plain reference
(``reference/google.py``) recomputes the range from the pool, phase 1 of
every call's dlatents and a sample of each call's perturbations (drawn
from the seed, the same number from every resolution), and compares them
with the records: ``phase1_gap`` the worst max |diff| / max |reference|
over the coordinates and the base logits, ``effect_gap`` the worst max
|diff| of the sampled logit changes over max |reference perturbed
logits|. The records keep the StylEx sweep's keys, so the sweep's readers
read them.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import common
from benchmark.counters import google as counters
from benchmark.reference import google as ref
from benchmark.reference import nets, ops

PRECISION = "float32"  # the sweep's, with TF32 off, as run_attfind runs it by default


def weight_shapes(c: dict, clf_kind: str) -> dict:
    """name -> shape: ``google.*`` (the program's converted generator's
    keys) and ``classifier.*`` (torchvision's)."""
    with torch.device("meta"):
        gen = ref.Generator(c)
        clf = nets.Classifier(clf_kind, c["image_size"], c["num_classes"])
    shapes = {f"google.{k}": tuple(v.shape) for k, v in gen.state_dict().items()}
    shapes.update({f"classifier.{k}": tuple(v.shape) for k, v in clf.net.state_dict().items()})
    return shapes


def make_weights(c: dict, clf_kind: str, seed: int, device) -> dict:
    """The classifier's weights as ``common.make_weights`` draws them; the
    generator's from one normal draw per tensor: the constant unit normal,
    conv and to-RGB weights over sqrt(fan-in), style kernels over
    sqrt(dlatent_dim), style biases 1 + 0.1 N (the scale a trained
    model's affine starts from), conv biases 0.02 N."""
    shapes = weight_shapes(c, clf_kind)
    out = common.make_weights({k: v for k, v in shapes.items() if k.startswith("classifier.")},
                              seed, device)
    gen = torch.Generator(device=device).manual_seed((int(seed) + 2) % (2 ** 63))
    for name, shape in shapes.items():
        if not name.startswith("google."):
            continue
        x = torch.randn(shape, generator=gen, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "style_kernel":
            x = x / math.sqrt(shape[0])
        elif leaf == "style_bias":
            x = 1.0 + 0.1 * x
        elif leaf == "bias":
            x = 0.02 * x
        elif leaf == "weight":
            x = x / math.sqrt(math.prod(shape[1:]))
        out[name] = x
    return out


def make_dlatents(c: dict, n: int, seed: int, device) -> torch.Tensor:
    """(n, dlatent_dim) float32: unit-normal dims and a one-hot class."""
    gen = torch.Generator(device=device).manual_seed((int(seed) + 1) % (2 ** 63))
    k = c["num_classes"]
    z = torch.randn(n, c["dlatent_dim"] - k, generator=gen, device=device)
    label = torch.randint(0, k, (n,), generator=gen, device=device)
    return torch.cat([z, torch.nn.functional.one_hot(label, k).float()], dim=1)


def _program(c: dict, clf_kind: str, weights: dict, device):
    """The program's generator and classifier with the benchmark's weights."""
    from stylex_tpu_torch.models.classifiers import ClassifierBundle, MobileNetV2, ResNet18
    from stylex_tpu_torch.models.google_stylex import GoogleStylExGenerator, GoogleStylExSpec

    spec = GoogleStylExSpec(image_size=c["image_size"], dlatent_dim=c["dlatent_dim"],
                            fmap_base=c["fmap_base"], fmap_max=c["fmap_max"])
    gen = GoogleStylExGenerator(spec, device="cpu").to(device)
    gen.load_state_dict(common.split(weights, "google"))
    with torch.device("meta"):
        net = ResNet18(c["num_classes"]) if clf_kind == "resnet" else MobileNetV2(c["num_classes"])
    net = net.to_empty(device=device)
    net.load_state_dict(common.split(weights, "classifier"))
    bundle = ClassifierBundle(clf_kind, net, c["image_size"], num_classes=c["num_classes"])
    return gen.eval(), bundle


def _reference(c: dict, clf_kind: str, weights: dict, device):
    gen = ref.Generator(c).to(device)
    gen.load_state_dict(common.split(weights, "google"))
    clf = nets.Classifier(clf_kind, c["image_size"], c["num_classes"]).to(device)
    clf.net.load_state_dict(common.split(weights, "classifier"))
    return gen.eval(), clf.eval()


def sample_ids(c: dict, n: int, per_block: int, seed: int, call: int):
    """(dlatent, direction, coordinate) of the perturbations compared in
    window call ``call``: ``per_block`` from every resolution."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), call])
    out, offset = [], 0
    for size in ref.block_sizes(c):
        k = min(per_block, 2 * n * size)
        flat = rng.choice(2 * n * size, size=k, replace=False)
        img, rest = np.divmod(flat, 2 * size)
        direction, coord = np.divmod(rest, size)
        out.append(np.stack([img, direction, coord + offset], axis=1))
        offset += size
    return np.concatenate(out)


def reference_outputs(c: dict, clf_kind: str, weights: dict, device, calls: list, pool,
                      p: dict, seed: int, precision: str = "float32", fault=None) -> list:
    """Per compared call, the reference's phase 1 of its dlatents and the
    logit changes of its sampled perturbations, at ``precision``: dicts of
    ``coords``, ``base``, ``images``, ``effects``, ``ids``.
    ``fault="next_coordinate"`` perturbs each sampled perturbation's next
    coordinate: an answer altered where it is made."""
    gen, clf = _reference(c, clf_kind, weights, device)
    out = []
    with ops.precision(precision):
        lo, hi = ref.style_range(gen, pool.to(device))
        for i, dl in enumerate(calls):
            w = torch.from_numpy(dl).to(device)
            coords, images, base = ref.phase1(gen, clf, w)
            ids = sample_ids(c, w.shape[0], p["compare_per_block"], seed, i)
            t = torch.from_numpy(ids).to(device)
            coord = t[:, 2]
            if fault == "next_coordinate":
                coord = (coord + 1) % coords.shape[1]
            eff = ref.effects(gen, clf, w, coords, base, lo, hi, t[:, 0], coord, t[:, 1] == 1,
                              p["shift_size"])
            out.append(dict(coords=coords.cpu(), base=base.cpu(), images=images.cpu(),
                            effects=eff.cpu(), ids=ids))
    del gen, clf
    common.free_device_memory()
    return out


def program_outputs(records, ref_out: list) -> list:
    """The same quantities read from the program's records."""
    out = []
    for rec, r in zip(records, ref_out):
        ids = r["ids"]
        out.append(dict(coords=torch.from_numpy(rec.style_coordinates),
                        base=torch.from_numpy(rec.base_prob),
                        images=torch.from_numpy(rec.original_images).permute(0, 3, 1, 2),
                        effects=torch.from_numpy(
                            rec.style_change[ids[:, 0], ids[:, 1], ids[:, 2]])))
    return out


def gaps(prog: list, ref_out: list) -> dict:
    """``phase1_gap`` (coordinates, base logits) and ``effect_gap``, with
    the base images' gap and the effects' own relative gap in ``detail``."""
    detail = {k: 0.0 for k in ("coords", "base", "images", "effect_rel_effects")}
    effect = 0.0
    for a, b in zip(prog, ref_out):
        for k in ("coords", "base", "images"):
            detail[k] = max(detail[k], common.relative_gap(a[k], b[k]))
        scale = (b["effects"] + b["base"][b["ids"][:, 0]]).abs().max().item()
        diff = (a["effects"].double() - b["effects"].double()).abs().max().item()
        effect = max(effect, diff / max(scale, 1e-30))
        detail["effect_rel_effects"] = max(detail["effect_rel_effects"],
                                           common.relative_gap(a["effects"], b["effects"]))
    return {"phase1_gap": max(detail["coords"], detail["base"]), "effect_gap": effect,
            "detail": detail}


def run(ctx) -> dict:
    from stylex_tpu_torch.attfind.extraction import attfind_extraction

    c, p, device, seed = ctx.config["model"], ctx.workload["params"], ctx.device, ctx.seed
    clf_kind = p["classifier"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = make_weights(c, clf_kind, seed, device)
    gen, clf = _program(c, clf_kind, weights, device)
    pool = make_dlatents(c, p["pool"], seed, device)
    n_dl = p["dlatents_per_call"]
    sets = pool[:p["sets"] * n_dl].cpu().numpy().reshape(p["sets"], n_dl, -1)
    with torch.no_grad():
        coords = torch.cat(gen.style_vectors(pool)[0], dim=-1)
    style_range = (coords.min(0).values.cpu().numpy(), coords.max(0).values.cpu().numpy())
    del coords

    def call(dlatents):
        return attfind_extraction(
            gen, clf.classify_images, dlatents, None, shift_size=p["shift_size"],
            coord_batch=p["coord_batch"], block_resume=True,
            compute_dtype=getattr(torch, PRECISION),
            chunks_per_dispatch=p["chunks_per_dispatch"], progress=False,
            style_range=style_range)

    call(sets[0])  # warm-up: every shape of the window
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = common.since_process_start()

    calls, walls = [], []
    trace = None
    t0 = time.perf_counter()
    i = 0
    while True:
        dlatents = sets[(i + 1) % p["sets"]]
        if ctx.trace and i == 0:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
            ts = time.perf_counter()
            with profile(activities=activities) as prof:
                rec = call(dlatents)
            traced_s = time.perf_counter() - ts
        else:
            ts = time.perf_counter()
            rec = call(dlatents)
        walls.append(time.perf_counter() - ts)
        calls.append((dlatents, rec))
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if ctx.trace:
        from benchmark import trace_summary

        trace = trace_summary.summarize(prof, traced_s)
        del prof
    styles = [r.style_change.shape[0] * 2 * r.style_change.shape[2] for _, r in calls]
    stage = [r.stage_walls for _, r in calls]

    failed = sum(int((~np.isfinite(r.style_change)).any(axis=3).sum()) for _, r in calls)
    records = [r for _, r in calls]
    inputs = [dl for dl, _ in calls]
    del gen, clf
    common.free_device_memory()
    ref_out = reference_outputs(c, clf_kind, weights, device, inputs, pool, p, seed)
    result = gaps(program_outputs(records, ref_out), ref_out)
    control = None
    if ctx.control:
        low = reference_outputs(c, clf_kind, weights, device, inputs, pool, p, seed,
                                ops.control_for(PRECISION))
        control = gaps(low, ref_out)
        shifted = reference_outputs(c, clf_kind, weights, device, inputs, pool, p, seed,
                                    fault="next_coordinate")
        control["fault_next_coordinate"] = {k: v for k, v in gaps(shifted, ref_out).items()
                                            if k != "detail"}
    counts = counters.attfind_call(c, clf_kind, n_dl) if ctx.trace else None
    return dict(
        kind="attfind", setup_s=setup_s, window_s=window_s, memory_peak_bytes=peak,
        styles=sum(styles), call_walls=walls, call_styles=styles, stage_walls=stage,
        chunks_per_call=counters.chunks_per_call(c, n_dl, p["coord_batch"]),
        trace=trace, counts=counts, traced_calls=1 if ctx.trace else 0,
        checks=[(k, result[k], limit) for k, limit in p["limits"].items()],
        attempted=sum(styles), failed=failed, control=control, detail=result["detail"],
        numbers={k: v for k, v in result.items() if k != "detail"},
        notes=dict(call_walls=walls, device_s_by_kind=trace and trace["kind_s"]),
        peak_flops=common.PEAK_FLOPS["float32"],
    )
