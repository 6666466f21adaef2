"""FLOPs and resample bytes of an AttFind extraction call and of a train
step, counted over the plain reference on the meta device.

FLOPs are those of the matrix products and convolutions (forward, and
backward where the step differentiates, second order included), as
``FlopCounterMode`` counts them. A recomputation the program chooses
(``remat``) is not counted, and an im2col or polyphase path counts as the
literal convolution it computes. Bytes count each input element read once
and each output element written once, at the given item size.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from benchmark.reference import nets, ops
from benchmark.reference import train_step as ref_step


class _FlopCount(TorchDispatchMode):
    """Sums ``torch.utils.flop_counter``'s formulas over the operators run
    inside (``FlopCounterMode`` without its module hooks, which
    ``autograd.grad`` does not take)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def count_flops(fn) -> int:
    with _FlopCount() as mode:
        fn()
    return int(mode.total)


@contextlib.contextmanager
def resample_calls():
    """Record the shapes of every bilinear upsample and blur the reference
    runs inside: yields ``{"upsample": [(in, out), ...], "blur": [...]}``
    in elements."""
    calls: Dict[str, List[tuple]] = {"upsample": [], "blur": []}
    up, blur = ops.upsample2x, ops.blur3

    def rec_up(x):
        y = up(x)
        calls["upsample"].append((x.numel(), y.numel()))
        return y

    def rec_blur(x):
        y = blur(x)
        calls["blur"].append((x.numel(), y.numel()))
        return y

    ops.upsample2x, ops.blur3 = rec_up, rec_blur
    try:
        yield calls
    finally:
        ops.upsample2x, ops.blur3 = up, blur


def block_sizes(c: dict) -> List[int]:
    """StyleSpace coordinates per generator block."""
    return [i + o for i, o in nets.block_dims(c["image_size"], c["network_capacity"],
                                               c["fmap_max"])]


def _meta_nets(c: dict, clf_kind: str):
    with torch.device("meta"):
        return nets.StylEx(c).eval(), nets.Classifier(clf_kind, c["image_size"],
                                                      c["num_classes"]).eval()


@torch.no_grad()
def attfind_call(c: dict, clf_kind: str, n_images: int, itemsize: int = 4) -> dict:
    """The work of one block-resume extraction call over ``n_images``:
    phase 1 (E, classifier, G with its coordinates, classifier, D) on the
    batch, then for each block k its ``2 * n_images * size_k``
    perturbations, each the generator from block k and the classifier.
    Returns ``flops``, ``perturbations``, and the resample ``bytes``
    (``upsample``, ``blur``) at ``itemsize`` bytes an element."""
    model, clf = _meta_nets(c, clf_kind)
    S, L, D = c["image_size"], model.num_layers, c["latent_dim"]
    dev = "meta"
    img = torch.empty(n_images, 3, S, S, device=dev)
    noise = torch.empty(1, S, S, 1, device=dev)
    coords = sum(block_sizes(c))

    def phase1():
        w = nets.make_w(c, model.encoder(img), clf(img))
        gen, _ = model.G(w[:, None].expand(-1, L, -1), noise)
        logits = clf(gen)
        model.D(gen, torch.softmax(logits, -1) if c["arch"] == "new" else None)

    totals = {"flops": 0, "upsample": 0, "blur": 0}

    def add(fn, times):
        with resample_calls() as calls:
            totals["flops"] += times * count_flops(fn)
        for k in ("upsample", "blur"):
            totals[k] += times * sum(a + b for a, b in calls[k]) * itemsize

    add(phase1, 1)
    styles = torch.empty(1, L, D, device=dev)
    perturbations = 0
    for k, size in enumerate(block_sizes(c)):
        state = model.G(styles, noise, stop_block=k)
        delta = torch.empty(1, coords, device=dev)

        def resume(state=state, k=k, delta=delta):
            gen, _ = model.G(styles, noise, style_delta=delta, start_block=k, state=state)
            clf(gen)

        n = 2 * n_images * size
        perturbations += n
        add(resume, n)
    return {"flops": totals["flops"], "perturbations": perturbations,
            "bytes": {"upsample": totals["upsample"], "blur": totals["blur"]}}


def _meta_draws(c: dict, t: dict, pl: bool):
    A, B, S = t["gradient_accumulate_every"], t["batch_size"], c["image_size"]
    P = A // 2
    mapping = c["latent_dim"] - c["num_classes"] if c["arch"] == "new" else c["latent_dim"]
    dev = "meta"
    n = A * B

    def aug():
        i = torch.empty(n, dtype=torch.long, device=dev)
        return (torch.empty(n, dtype=torch.bool, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev), ((i, i), (i, i)))

    def phase(g: bool):
        return dict(z1=torch.empty(P, B, mapping, device=dev),
                    z2=torch.empty(P, B, mapping, device=dev),
                    mixed=torch.empty(P, dtype=torch.bool, device=dev),
                    cutoff=torch.empty(P, dtype=torch.long, device=dev),
                    noise=torch.empty(A, B, S, S, 1, device=dev),
                    aug_fake=aug(), aug_real=aug(),
                    pl_noise=torch.empty(A, B, 3, S, S, device=dev) if (g and pl) else None)

    return {"d": phase(False), "g": phase(True)}


def train_step(c: dict, t: dict, clf_kind: str, step: int) -> int:
    """FLOPs of the train step numbered ``step`` (its GP and PL flags)."""
    model, clf = _meta_nets(c, clf_kind)
    for p in clf.parameters():
        p.requires_grad_(False)
    with torch.device("meta"):
        lpips = {k: torch.empty(v) for k, v in nets.lpips_shapes().items()}
    fl = ref_step.flags(t, step)
    A, B, S = t["gradient_accumulate_every"], t["batch_size"], c["image_size"]
    batch = {k: torch.empty(A, B, S, S, 3, dtype=torch.uint8, device="meta")
             for k in ("d_real", "d_enc", "g_imgs")}
    draws = _meta_draws(c, t, fl["pl"])
    run = ref_step.Step(model, clf, lpips, t)
    pl_mean = torch.empty((), device="meta")
    return count_flops(lambda: run(batch, draws, step, pl_mean))


def window_train_flops(c: dict, t: dict, clf_kind: str, steps: List[int]) -> int:
    """FLOPs of the listed steps, each kind of step (GP, PL) counted once."""
    cache: Dict[tuple, int] = {}
    total = 0
    for s in steps:
        fl = ref_step.flags(t, s)
        key = (fl["gp"], fl["pl"])
        if key not in cache:
            cache[key] = train_step(c, t, clf_kind, s)
        total += cache[key]
    return total


def chunks_per_call(c: dict, n_images: int, coord_batch: int) -> int:
    """Sweep chunks of one block-resume call: each block's perturbations in
    chunks of ``coord_batch``."""
    return sum(math.ceil(2 * n_images * size / coord_batch) for size in block_sizes(c))
