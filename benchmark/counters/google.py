"""FLOPs and upsample bytes of an AttFind call on Google's generator from
dlatents, counted over the plain reference (``reference/google.py``) on
the meta device, as :mod:`benchmark.counters.work` counts the StylEx sweep:
the formulas of ``torch.utils.flop_counter`` (convolutions and matrix
products; a grouped per-sample-weight conv counts as the dense conv it
computes), and each upsample's input read once and output written once.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.counters import work
from benchmark.reference import google as ref
from benchmark.reference import nets


def _meta_nets(c: dict, clf_kind: str):
    with torch.device("meta"):
        return ref.Generator(c).eval(), nets.Classifier(clf_kind, c["image_size"],
                                                        c["num_classes"]).eval()


@torch.no_grad()
def forward_flops(c: dict) -> int:
    """FLOPs of one image's generator forward: the convs, the to-RGBs and
    the style affines."""
    gen, _ = _meta_nets(c, "mobilenet")
    w = torch.empty(1, c["dlatent_dim"], device="meta")
    return work.count_flops(lambda: gen(w))


@torch.no_grad()
def attfind_call(c: dict, clf_kind: str, n_dlatents: int, itemsize: int = 4) -> Dict:
    """The work of one resume-by-resolution call over ``n_dlatents``: phase
    1 (style vectors, generator, classifier) on each, then for each
    resolution k its ``2 * n_dlatents * size_k`` perturbations, each the
    generator from resolution k and the classifier. Returns ``flops``,
    ``perturbations`` and the resample ``bytes`` (``upsample``; ``blur``
    0: this generator has none)."""
    gen, clf = _meta_nets(c, clf_kind)
    w = torch.empty(1, c["dlatent_dim"], device="meta")
    coords = sum(ref.block_sizes(c))
    totals = {"flops": 0, "upsample": 0}

    def add(fn, times):
        with work.resample_calls() as calls:
            totals["flops"] += times * work.count_flops(fn)
        totals["upsample"] += times * sum(a + b for a, b in calls["upsample"]) * itemsize

    add(lambda: ref.phase1(gen, clf, w), n_dlatents)
    delta = torch.empty(1, coords, device="meta")
    perturbations = 0
    for k, size in enumerate(ref.block_sizes(c)):
        state = gen(w, stop_block=k)

        def resume(state=state, k=k):
            clf(ref.to_unit(gen(w, delta, start_block=k, state=state)))

        n = 2 * n_dlatents * size
        perturbations += n
        add(resume, n)
    return {"flops": totals["flops"], "perturbations": perturbations,
            "bytes": {"upsample": totals["upsample"], "blur": 0}}


def chunks_per_call(c: dict, n_dlatents: int, coord_batch: int) -> int:
    """Sweep chunks of one resume call: each resolution's perturbations in
    chunks of ``coord_batch``."""
    return sum(math.ceil(2 * n_dlatents * size / coord_batch) for size in ref.block_sizes(c))
