"""Training traffic: ``Trainer.train()`` called step after step, as the
training CLI calls it, on a folder of seeded JPEGs, with the step's random
draws made by the benchmark from the seed and passed in.

Set-up writes the image folder once per checkout (it does not depend on
the seed), builds the program's trainer at the configuration's settings,
loads the benchmark's weights (made on the device from the seed) into its
model, classifier and LPIPS, and sets the step counter and ``pl_mean`` as a
resumed run has them. It then runs the first steps through ``train()``:
the first three are compared with the reference after the window, and
together they warm every shape of the window (the first is a GP and PL
step with the EMA update due two steps later, when an evaluation also
runs). The window calls ``train()`` until ``--seconds`` have passed and
ends in a synchronise; a CUDA event recorded after each call times the
steps on the device's clock. The window's first three steps are compared
too: set-up ends by copying the program's state to the host, and after
the window's first step and its third this module reads, on the device and
without waiting, the norms of the gradient Adam got and of each
parameter's change. With ``--trace 1`` the ``trace_steps`` steps after
those three are traced.

After the window the trainer is closed and freed, and the plain reference
runs the three set-up steps from the same weights, batches and draws, and
the window's three from the program's state as the window started. It
decodes the JPEGs itself and takes each batch image the loader gave only
where it equals one of its own decodes.
"""

from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import common
from benchmark.counters import work
from benchmark.reference import nets, ops
from benchmark.reference import train_step as ref_step

COMPARED = 3  # steps followed by the reference, at set-up and in the window
# the first step's losses computed on the initial weights
BEFORE_UPDATE = ("d_loss", "gp", "rec_loss", "kl_loss", "pl_mean")


# ---------------------------------------------------------------- the data


def image_folder(size: int, count: int) -> Path:
    """``count`` seeded JPEGs of ``size`` px, written once per checkout
    (under the run-time directory, at a fixed path) and reused."""
    from PIL import Image

    folder = common.WORK / "data" / f"jpeg{size}x{count}"
    if (folder / "complete").exists():
        return folder
    partial = folder.with_name(folder.name + ".partial")
    shutil.rmtree(partial, ignore_errors=True)
    partial.mkdir(parents=True)
    gen = torch.Generator().manual_seed(20211010)
    for start in range(0, count, 64):
        n = min(64, count - start)
        x = common.smooth_images(gen, n, size, "cpu")
        arr = (x.permute(0, 2, 3, 1).numpy() * 255.0 + 0.5).astype(np.uint8)
        for i in range(n):
            Image.fromarray(arr[i]).save(partial / f"{start + i:05d}.jpg", quality=90)
    (partial / "complete").write_text("")
    shutil.rmtree(folder, ignore_errors=True)
    partial.rename(folder)
    return folder


def decode_folder(folder: Path) -> np.ndarray:
    """Every JPEG of the folder as (n, S, S, 3) uint8, sorted by name."""
    from PIL import Image

    return np.stack([np.asarray(Image.open(p).convert("RGB"))
                     for p in sorted(folder.glob("*.jpg"))])


def own_batches(captured: list, decoded: np.ndarray):
    """The reference's copies of the captured batches: each image replaced
    by the decoded image it equals. Returns (batches, images not found)."""
    index = {img.tobytes(): i for i, img in enumerate(decoded)}
    missing, out = 0, []
    for batch in captured:
        own = {}
        for k, v in batch.items():
            flat = v.reshape(-1, *v.shape[-3:])
            ids = [index.get(np.ascontiguousarray(img).tobytes(), -1) for img in flat]
            missing += sum(i < 0 for i in ids)
            own[k] = decoded[np.maximum(ids, 0)].reshape(v.shape)
        out.append(own)
    return out, missing


# --------------------------------------------------------------- the draws


def draw(gen, c: dict, t: dict, aug_prob: float, step: int) -> dict:
    """Every random draw of step ``step`` from ``gen``, as plain tensors:
    for the D and the G phase the mixing latents and cut-offs, the noise
    images, DiffAugment's gates, flips, translations and cutout centres,
    and on PL steps the G phase's projection noise."""
    A, B, S = t["gradient_accumulate_every"], t["batch_size"], c["image_size"]
    P = A // 2
    L = int(np.log2(S)) - 1
    mapping = c["latent_dim"] - c["num_classes"] if c["arch"] == "new" else c["latent_dim"]
    dev = gen.device
    pl = ref_step.flags(t, step)["pl"]

    def aug():
        n, s, cut = A * B, int(S * 0.125 + 0.5), int(S * 0.5 + 0.5)

        def randint(lo, hi):
            return torch.randint(lo, hi, (n,), generator=gen, device=dev)

        ops_ = ((randint(-s, s + 1), randint(-s, s + 1)),
                (randint(0, S + (1 - cut % 2)), randint(0, S + (1 - cut % 2))))
        gate = (torch.rand(A, generator=gen, device=dev) < aug_prob).repeat_interleave(B)
        flip = (torch.rand(A, generator=gen, device=dev) < 0.5).repeat_interleave(B)
        return gate, flip, ops_

    def phase(g: bool) -> dict:
        return dict(
            z1=torch.randn(P, B, mapping, generator=gen, device=dev),
            z2=torch.randn(P, B, mapping, generator=gen, device=dev),
            mixed=torch.rand(P, generator=gen, device=dev) < t["mixed_prob"],
            cutoff=torch.randint(0, L, (P,), generator=gen, device=dev),
            noise=torch.rand(A, B, S, S, 1, generator=gen, device=dev),
            aug_fake=aug(), aug_real=aug(),
            pl_noise=torch.randn(A, B, 3, S, S, generator=gen, device=dev) if g and pl else None)

    return {"d": phase(False), "g": phase(True)}


def program_draws(d: dict):
    """The program's ``StepDraws`` holding the same tensors."""
    from stylex_tpu_torch.ops.diffaug import AugmentDraws
    from stylex_tpu_torch.train.steps import PhaseDraws, StepDraws

    def phase(x):
        aug = {k: AugmentDraws(x[k][0], x[k][1], x[k][2]) for k in ("aug_fake", "aug_real")}
        return PhaseDraws(z1=x["z1"], z2=x["z2"], mixed=x["mixed"], cutoff=x["cutoff"],
                          noise=x["noise"], pl_noise=x["pl_noise"], **aug)

    return StepDraws(phase(d["d"]), phase(d["g"]))


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def to_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


# ------------------------------------------------------------- comparison


def _device_norms(tensors) -> torch.Tensor:
    """Per-leaf norms, on the tensors' device (read without waiting)."""
    return torch.stack([t.detach().double().norm() for t in tensors])


def _norms(tensors) -> torch.Tensor:
    return _device_norms(tensors).cpu()


def _adam_moments(state) -> dict:
    return {**state.d_opt.state, **state.g_opt.state}


def _grad_norms(state, params, before=None) -> torch.Tensor:
    """Per-leaf norms of the gradient Adam got in the step just taken, from
    its first moment: m = beta1 m_before + (1 - beta1) g (m_before 0 after
    the first step); leaves without Adam state read 0."""
    moments = _adam_moments(state)
    beta1 = state.g_opt.param_groups[0]["betas"][0]
    out = []
    for q in params:
        if q not in moments:
            out.append(torch.zeros_like(q))
            continue
        m = moments[q]["exp_avg"]
        if before is not None:
            m = m - beta1 * before[q]
        out.append(m / (1 - beta1))
    return _device_norms(out)


def _snapshot(state, names, params) -> dict:
    """The program's state on the host as the window starts: the model's
    parameters and buffers, each parameter's Adam moments by name, Adam's
    step count and ``pl_mean``."""
    moments = _adam_moments(state)
    def host(x):  # a copy, also where the state is on the host already
        return x.detach().to("cpu", copy=True)

    adam = {n: (host(moments[q]["exp_avg"]), host(moments[q]["exp_avg_sq"]))
            for n, q in zip(names, params) if q in moments}
    counts = sorted({int(moments[q]["step"]) for q in params if q in moments})
    return dict(model={k: host(v) for k, v in state.model.state_dict().items()},
                adam=adam, adam_steps=counts, pl_mean=float(state.pl_mean))


def half_batch(tree, accum: int):
    """Micro-batches A/2.. replaced by 0..A/2-1, in the step's images and
    draws: half of the batch left out, the mean taken over the rest."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        x = torch.as_tensor(tree)
        if x.dim() == 0:
            return x
        h = accum // 2
        if x.shape[0] == accum:  # (A, B, ...)
            return torch.cat([x[:h], x[:h]])
        if x.shape[0] % accum == 0:  # (A*B, ...) flat over the micro-batches
            b = x.shape[0] // accum
            return torch.cat([x[:h * b], x[:h * b]])
        if x.shape[0] == h:  # (P, ...) per prior micro-batch
            return torch.cat([x[:h // 2], x[:h // 2]]) if h > 1 else x
        return x
    if isinstance(tree, dict):
        return {k: half_batch(v, accum) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(half_batch(v, accum) for v in tree)
    return tree


def reference_readings(c, t, clf_kind, weights, device, batches, draws, start, pl_mean,
                       precision="float32", fault=None, state=None) -> dict:
    """The reference's losses of the compared steps, its per-leaf norms of
    the first step's gradients and of every parameter's change after them
    (leaves in the order of ``names``), at ``precision``; with
    ``fault="half_batch"`` on half of each step's batch (:func:`half_batch`).
    It starts from the benchmark's weights with fresh Adam state, or from
    a program's ``state`` (:func:`_snapshot`)."""
    if fault == "half_batch":
        A = t["gradient_accumulate_every"]
        batches, draws = half_batch(batches, A), half_batch(draws, A)
    model = nets.StylEx(c).to(device)
    start_weights = common.split(weights, "stylex") if state is None else state["model"]
    model.load_state_dict({k: v.to(device) for k, v in start_weights.items()})
    clf = nets.Classifier(clf_kind, c["image_size"], c["num_classes"]).to(device).eval()
    clf.net.load_state_dict(
        {k: v.to(device) for k, v in common.split(weights, "classifier").items()})
    clf.requires_grad_(False)
    lpips = {k: v.to(device) for k, v in common.split(weights, "lpips").items()}
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    init = [p.detach().clone() for p in params]
    step = ref_step.Step(model, clf, lpips, t)
    if state is not None:
        by_name = dict(model.named_parameters())
        moments = {id(by_name[n]): (m.to(device), v.to(device))
                   for n, (m, v) in state["adam"].items()}
        for opt in (step.g_opt, step.d_opt):
            opt.load(moments, max(state["adam_steps"]))
        pl_mean = state["pl_mean"]
    losses, grad_norms = [], None
    pl = torch.tensor(pl_mean, device=device)
    with ops.precision(precision):
        for i in range(COMPARED):
            out, grads, pl = step(to_device(batches[i], device), to_device(draws[i], device),
                                  start + i, pl)
            losses.append({k: float(v.detach()) for k, v in out.items()})
            if i == 0:
                grad_norms = _norms([grads.get(id(p), torch.zeros_like(p)) for p in params])
    change = _norms([p.detach() - p0 for p, p0 in zip(params, init)])
    del model, step
    common.free_device_memory()
    return dict(names=names, losses=losses, grad_norms=grad_norms, change_norms=change)


def gaps(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the largest |diff| over the first step's losses that
    precede every update (``BEFORE_UPDATE``; ``g_loss`` reads D after its
    first Adam step), each over the larger of its reference value and a
    thousandth of the step's largest reference loss (a loss that is
    nought next to the others, as the classifier KL of a frozen random
    classifier, is judged on the step's scale); ``loss_gap_all_steps``
    the same over every loss of every compared step (the later ones swing
    with the rounding that Adam amplifies).
    ``grad_gap`` and ``change_gap``: the worst leaf's |norm diff| over the
    larger of its reference norm and the median leaf's, and ``*_median``
    the median leaf's. The change leaves out leaves whose first reference
    gradient is under a thousandth of the median leaf's (moved by
    round-off alone under Adam); frozen leaves (the EMA copies) stay."""
    loss, loss_all, detail = 0.0, 0.0, {}
    for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"])):
        floor = 1e-3 * max(abs(v) for v in b.values())
        for k, rv in b.items():
            pv = a.get(k)
            if pv is None:
                loss = loss_all = float("inf")
                continue
            gap = abs(pv - rv) / max(abs(rv), floor, 1e-30)
            detail[f"step{i}.{k}"] = [pv, rv, gap]
            loss_all = max(loss_all, gap)
            if i == 0 and k in BEFORE_UPDATE:
                loss = max(loss, gap)
    order = {n: i for i, n in enumerate(prog["names"])}
    idx = torch.tensor([order[n] for n in ref["names"]])
    pg, pc = prog["grad_norms"][idx], prog["change_norms"][idx]
    rg, rc = ref["grad_norms"], ref["change_norms"]
    trained = rg > 0
    med_g = rg[trained].median()
    g_all = torch.where(trained, (pg - rg).abs() / torch.maximum(rg, med_g), torch.zeros_like(rg))
    keep = (rg >= 1e-3 * med_g) | ~trained
    med_c = rc[keep].median()
    c_all = torch.where(keep, (pc - rc).abs() / torch.maximum(rc, med_c), torch.zeros_like(rc))
    for tag, v in (("grad", g_all), ("change", c_all)):
        top = torch.topk(v, min(3, v.numel()))
        detail[f"worst_{tag}"] = [[ref["names"][j], v[j].item()] for j in top.indices.tolist()]
    detail["change_left_out"] = [ref["names"][j] for j in (~keep).nonzero()[:, 0].tolist()]
    return {"loss_gap": loss, "loss_gap_all_steps": loss_all, "grad_gap": g_all.max().item(),
            "change_gap": c_all.max().item(),
            "grad_gap_median": g_all[trained].median().item(),
            "change_gap_median": c_all[keep].median().item(), "detail": detail}


# ------------------------------------------------------------------- run


class _LoaderTap:
    """The trainer's loader, keeping a copy of each step batch it yields."""

    def __init__(self, loader):
        self.loader, self.batches = loader, []

    def __next__(self):
        batch = next(self.loader)
        self.batches.append({k: np.array(v) for k, v in batch.items()})
        return batch

    def __getattr__(self, name):
        return getattr(self.loader, name)


class _LoggerTap:
    """The trainer's metric logger, keeping every (step, metrics) it logs."""

    def __init__(self, logger):
        self.logger, self.rows = logger, {}

    def log(self, step, metrics):
        self.rows[step] = dict(metrics)
        self.logger.log(step, metrics)

    def __getattr__(self, name):
        return getattr(self.logger, name)


def _program_trainer(ctx, c, t, clf_kind, folder, weights, device):
    from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig
    from stylex_tpu_torch.train.trainer import Trainer

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in t.items() if k in fields})
    mcfg = ModelConfig(**{k: v for k, v in c.items() if k in common.MODEL_KEYS},
                       arch=Arch(c["arch"]), remat=bool(c.get("remat", False)))
    base = common.WORK / "train" / ctx.workload["name"]
    shutil.rmtree(base, ignore_errors=True)
    trainer = Trainer(name=ctx.workload["name"], base_dir=str(base), model_cfg=mcfg,
                      train_cfg=tcfg, classifier_name=clf_kind, seed=int(ctx.seed) % (2 ** 32),
                      device=device)
    trainer.set_data_src(str(folder))
    trainer.init_stylex()
    model = trainer.state.model
    model.load_state_dict({k: v.to(device) for k, v in common.split(weights, "stylex").items()})
    trainer.classifier.net.load_state_dict(
        {k: v.to(device) for k, v in common.split(weights, "classifier").items()})
    with torch.no_grad():
        for k, v in common.split(weights, "lpips").items():
            if k.startswith("lin"):
                trainer.lpips_params[k].copy_(v)
            else:
                conv, leaf = k.split(".")
                trainer.lpips_params[conv][leaf].copy_(v)
    return trainer



def run(ctx) -> dict:
    c, t, p = ctx.config["model"], ctx.config["train"], ctx.workload["params"]
    clf_kind, device, seed = p["classifier"], ctx.device, ctx.seed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    folder = image_folder(c["image_size"], p["images"])
    weights = common.make_weights(common.reference_shapes(c, clf_kind, True), seed, device)
    trainer = _program_trainer(ctx, c, t, clf_kind, folder, weights, device)
    weights = {k: v.cpu() for k, v in weights.items()}
    state = trainer.state
    start = p["start_step"]
    state.step = start
    state.pl_mean = torch.tensor(p["pl_mean"], device=device)
    gen = torch.Generator(device=device).manual_seed((int(seed) + 2) % (2 ** 63))
    aug_prob = float(trainer.aug_prob or 0.0)

    # the compared steps and the rest of the warm-up, through train()
    names = [n for n, _ in state.model.named_parameters()]
    params = [q for _, q in state.model.named_parameters()]
    init = [q.detach().clone() for q in params]
    loader_tap, logger_tap = _LoaderTap(trainer.loader), _LoggerTap(trainer.logger)
    trainer.loader, trainer.logger = loader_tap, logger_tap
    draws_kept, grad_norms, change_norms = [], None, None
    for i in range(p["warmup_steps"]):
        d = draw(gen, c, t, aug_prob, start + i)
        if i < COMPARED:
            draws_kept.append(to_device(d, "cpu"))
        trainer.train(program_draws(d))
        if i == 0:
            grad_norms = _grad_norms(state, params).cpu()
        if i == COMPARED - 1:
            change_norms = _norms([q.detach() - q0 for q, q0 in zip(params, init)])
    trainer.flush()
    trainer.loader = loader_tap.loader
    del init
    prog = dict(names=names, grad_norms=grad_norms, change_norms=change_norms,
                losses=[{k: v for k, v in logger_tap.rows.get(start + i, {}).items()
                         if k in ("d_loss", "gp", "g_loss", "rec_loss", "kl_loss", "pl_mean")}
                        for i in range(COMPARED)])
    captured = loader_tap.batches[:COMPARED]
    first = start + p["warmup_steps"]
    # the window's first steps are compared from the state they start from
    snapshot = _snapshot(state, names, params)
    moments = _adam_moments(state)
    m_before = {q: moments[q]["exp_avg"].clone() for q in params if q in moments}
    p_before = [q.detach().clone() for q in params]
    window_tap = _LoaderTap(trainer.loader)
    trainer.loader = window_tap
    window_draws, window_grad, window_change = [], None, None

    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats()
    else:
        setup_peak = 0
    setup_s = common.since_process_start()

    events, trace, steps = [], None, 0
    prof = None
    trace_to = COMPARED + p["trace_steps"]
    least = trace_to if ctx.trace else COMPARED
    if on_gpu:
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        events.append(e0)
    t0 = time.perf_counter()
    while True:
        if ctx.trace and steps == COMPARED:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CUDA if on_gpu else ProfilerActivity.CPU]
            prof = profile(activities=activities)
            prof.__enter__()
            ts = time.perf_counter()
        d = draw(gen, c, t, aug_prob, first + steps)
        if steps < COMPARED:
            window_draws.append(_clone(d))
        trainer.train(program_draws(d))
        if on_gpu:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        steps += 1
        if steps == 1:
            window_grad, m_before = _grad_norms(state, params, m_before), None
        if steps == COMPARED:
            window_change = _device_norms([q.detach() - q0 for q, q0 in zip(params, p_before)])
            p_before, trainer.loader = None, window_tap.loader
        if prof is not None and steps == trace_to:
            if on_gpu:
                torch.cuda.synchronize()
            traced_s = time.perf_counter() - ts
            prof.__exit__(None, None, None)
        if steps >= least and time.perf_counter() - t0 >= ctx.seconds:
            break
    if on_gpu:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    window_peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    if prof is not None:
        from benchmark import trace_summary

        trace = trace_summary.summarize(prof, traced_s)
        del prof
    trainer.close()
    failed = sum(1 for s, m in logger_tap.rows.items()
                 if not all(np.isfinite(v) for v in m.values()))
    prog_window = dict(names=names, grad_norms=window_grad.cpu(),
                       change_norms=window_change.cpu(),
                       losses=[{k: v for k, v in logger_tap.rows.get(first + i, {}).items()
                                if k in ("d_loss", "gp", "g_loss", "rec_loss", "kl_loss",
                                         "pl_mean")} for i in range(COMPARED)])
    del trainer, state, params, moments, window_grad, window_change
    common.free_device_memory()

    decoded = decode_folder(folder)
    batches, missing = own_batches(captured, decoded)
    window_batches, window_missing = own_batches(window_tap.batches[:COMPARED], decoded)
    window_draws = to_device(window_draws, "cpu")
    runs = dict(setup=(batches, draws_kept, start, p["pl_mean"], None),
                window=(window_batches, window_draws, first, None, snapshot))

    def readings(part, **kw):
        b, d, s0, pl, st = runs[part]
        return reference_readings(c, t, clf_kind, weights, device, b, d, s0, pl, state=st, **kw)

    def both(measured: dict, part_readings) -> dict:
        """The numbers of the set-up steps and, prefixed ``window_``, of the
        window's, of ``measured`` (per part) against the reference."""
        out = {}
        for part, prefix in (("setup", ""), ("window", "window_")):
            for k, v in gaps(measured[part], part_readings[part]).items():
                if k == "detail":
                    out.setdefault("detail", {}).update({prefix + dk: dv for dk, dv in v.items()})
                else:
                    out[prefix + k] = v
        return out

    ref = {part: readings(part) for part in runs}
    result = both(dict(setup=prog, window=prog_window), ref)
    result["detail"]["window_adam_steps"] = snapshot["adam_steps"]
    control = raw = None
    if ctx.control:
        low = {part: readings(part, precision=ops.control_for(t["compute_dtype"]))
               for part in runs}
        control = both(low, ref)
        half = {part: readings(part, fault="half_batch") for part in runs}
        control["fault_half_batch"] = {k: v for k, v in both(half, ref).items() if k != "detail"}
        raw = {f"{name}.{part}": {k: (v.tolist() if torch.is_tensor(v) else v)
                                  for k, v in r[part].items()}
               for name, r in (("program", dict(setup=prog, window=prog_window)),
                               ("reference", ref), ("control", low), ("half_batch", half))
               for part in runs}
    images_per_step = t["batch_size"] * t["gradient_accumulate_every"]
    flops = None
    if ctx.trace:
        flops = work.window_train_flops(c, t, clf_kind, list(range(first, first + steps)))
    dtype = t["compute_dtype"]
    return dict(
        kind="train", setup_s=setup_s, window_s=window_s, steps=steps,
        images=steps * images_per_step, step_ms=step_ms,
        memory_peak_bytes=max(setup_peak, window_peak), window_peak_bytes=window_peak,
        trace=trace, traced_steps=p["trace_steps"] if ctx.trace else 0, window_flops=flops,
        peak_flops=common.PEAK_FLOPS[dtype],
        checks=[("images_not_from_folder", float(missing + window_missing), 0.0)]
        + [(k, result[k], limit) for k, limit in p["limits"].items()],
        attempted=steps + p["warmup_steps"], failed=failed, control=control,
        detail=result["detail"], numbers={k: v for k, v in result.items() if k != "detail"},
        notes=dict(steps=steps, step_ms_median=float(np.median(step_ms)) if step_ms else None,
                   step_ms=[round(x, 1) for x in step_ms],
                   device_s_by_kind=trace and trace["kind_s"]),
        raw=raw,
    )
