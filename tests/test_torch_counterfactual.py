"""The port's counterfactual evaluation against the JAX package's, on the
CPU, OLD and NEW arch, at 32 pixels and capacity 4.

The JAX parameters are carried across (``stylex_state_dict_from_jax``,
``classifier_state_dict_from_jax``) and both packages read the same
records. The greedy search with discriminator rejection gives identical
picks and rejected lists: its threshold lies between the probed styles'
D moves, and the test asserts every move is farther from it than the
packages' rounding. The counterfactual images (direction flips, a
compounding repeated pick) agree within 1e-4, and ``fid_topk`` with a
shared feature function within rtol 1e-3, its CSV row by row.
"""

import csv

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.attfind.extraction import AttFindRecords as JRecords
from stylex_tpu.config import Arch as JArch
from stylex_tpu.config import ModelConfig as JModelConfig
from stylex_tpu.eval import counterfactual as jcf
from stylex_tpu.models import build_stylex as j_build_stylex, init_stylex_params
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu_torch.attfind import AttFindRecords
from stylex_tpu_torch.config import Arch, ModelConfig
from stylex_tpu_torch.eval import counterfactual as cf
from stylex_tpu_torch.models import build_classifier
from stylex_tpu_torch.models.convert import (
    classifier_state_dict_from_jax,
    stylex_state_dict_from_jax,
)
from stylex_tpu_torch.models.stylex import StylEx

torch.set_num_threads(2)

SMALL = dict(image_size=32, network_capacity=4, latent_dim=34, encoder_dim=32)
N = 8
HEAD_SCALE = 1e3
# (direction, sindex as a fraction of C, class-0 effect): the styles whose
# effects exceed the probe's 0.2, so that D is probed for them
STRONG = [(0, 0.02, 0.95), (1, 0.35, 0.9), (0, 0.5, 0.85), (1, 0.97, 0.8), (0, 0.2, 0.75),
          (1, 0.7, 0.7)]


@pytest.fixture(scope="module", params=["old", "new"])
def setup(request):
    arch = request.param
    jcfg = JModelConfig(**SMALL, arch=JArch(arch))
    modules = j_build_stylex(jcfg)
    params = init_stylex_params(jax.random.PRNGKey(1), modules)
    clf_j = j_build_classifier("mobilenet", 32)
    variables = jax.tree.map(np.asarray, clf_j.variables)
    variables["params"]["classifier"]["kernel"] = (
        variables["params"]["classifier"]["kernel"] * HEAD_SCALE)
    clf_j.variables = jax.tree.map(jnp.asarray, variables)
    cfg = ModelConfig(**SMALL, arch=Arch(arch))
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg))
    clf = build_classifier("mobilenet", 32, device="cpu")
    clf.net.load_state_dict(classifier_state_dict_from_jax(variables, "mobilenet"))

    C = model.total_style_coords
    rng = np.random.RandomState(3)
    coords = rng.randn(N, C).astype(np.float32)
    style_change = rng.uniform(0.0, 0.05, (N, 2, C, 2)).astype(np.float32)
    strong = []
    for d, frac, eff in STRONG:
        s = int(frac * (C - 1))
        style_change[:, d, s, 0] = eff + rng.uniform(-0.01, 0.01, N)
        strong.append((d, s))
    base_prob = rng.randn(N, 2).astype(np.float32)
    base_prob[:3, 0] += 3.0  # both classes, so some images flip
    base_prob[3:, 1] += 3.0
    fields = dict(
        style_change=style_change,
        latents=rng.randn(N, cfg.latent_dim).astype(np.float32),
        base_prob=base_prob,
        minima=coords.min(0) - 0.5,
        maxima=coords.max(0) + 0.5,
        style_coordinates=coords,
        original_images=rng.rand(N, 32, 32, 3).astype(np.float32),
        noise=rng.rand(1, 32, 32, 1).astype(np.float32),
        discriminator=np.zeros((N, 1), np.float32),
    )
    return dict(jax=(modules, params, clf_j.classify_images),
                port=(model.eval(), clf.classify_images), records=AttFindRecords(**fields),
                jrecords=JRecords(**fields), strong=strong)


def _max_move(model, clf, records, direction, sindex):
    """The largest D move the filter's probe sees for this style."""
    idx = np.flatnonzero(records.style_change[:, direction, sindex, 0] > 0.2)[:cf.PROBE_IMAGES]
    idx = np.concatenate([idx, np.full(cf.PROBE_IMAGES - len(idx), idx[0])])
    extreme = records.minima[sindex] if direction == 0 else records.maxima[sindex]
    deltas = np.zeros((len(idx), records.style_change.shape[2]), np.float32)
    deltas[:, sindex] = (extreme - records.style_coordinates[idx, sindex]) * 2.0
    return float(cf._probe(model, clf, records.latents[idx], records.noise, deltas).max())


def test_filtered_search_matches_jax(setup):
    model, clf = setup["port"]
    rec = setup["records"]
    moves = sorted(_max_move(model, clf, rec, d, s) for d, s in setup["strong"])
    # a threshold in the widest gap that rejects some probed styles and passes others
    gaps = [(moves[i + 1] - moves[i], i) for i in range(len(moves) - 1)]
    _, i = max(gaps)
    threshold = 0.5 * (moves[i] + moves[i + 1])
    margin = min(abs(m - threshold) for m in moves)
    assert margin > 1e-3 * threshold

    kw = dict(num_indices=3, class_index=0, max_image_effect=0.2,
              discriminator_threshold=threshold)
    picks, rejected = cf.find_significant_styles_filtered(rec, model=model, classifier_fn=clf,
                                                          **kw)
    modules, params, clf_j = setup["jax"]
    want = jcf.find_significant_styles_filtered(setup["jrecords"], modules=modules,
                                                params=params, classifier_fn=clf_j, **kw)
    assert (picks, rejected) == want
    assert rejected and len(picks) == 3
    plain = cf.find_significant_styles_filtered(rec, 3, 0, use_discriminator=False)
    assert plain == jcf.find_significant_styles_filtered(setup["jrecords"], 3, 0,
                                                         use_discriminator=False)
    assert plain[1] == []


def test_filtered_search_stops_when_styles_run_out(setup):
    """Effects on four coordinates only, every one probed and rejected in
    both directions: the search ends with no pick once no positive effect
    is left, as the JAX package's termination guards have it."""
    model, clf = setup["port"]
    sc = np.zeros_like(setup["records"].style_change)
    sc[:, :, :4, 0] = 0.5
    kw = dict(num_indices=50, class_index=0, max_image_effect=100.0,
              discriminator_threshold=-1.0, sindex_offset=7)
    got = cf.find_significant_styles_filtered(
        AttFindRecords(**{**setup["records"].__dict__, "style_change": sc}), model=model,
        classifier_fn=clf, **kw)
    modules, params, clf_j = setup["jax"]
    want = jcf.find_significant_styles_filtered(
        JRecords(**{**setup["jrecords"].__dict__, "style_change": sc}), modules=modules,
        params=params, classifier_fn=clf_j, **kw)
    assert got == want
    assert got[0] == [] and sorted(got[1]) == [0, 0, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_counterfactual_images_match_jax(setup, k):
    model, clf = setup["port"]
    modules, params, clf_j = setup["jax"]
    s = setup["strong"]
    picks = [s[0], s[1], (1 - s[0][0], s[0][1])]  # the third shifts s[0]'s coordinate again
    got = cf.create_counterfactual_dataset(model, clf, setup["records"], picks, k, batch_size=5)
    want = np.asarray(jcf.create_counterfactual_dataset(modules, params, clf_j,
                                                        setup["jrecords"], picks, k,
                                                        batch_size=5))
    assert got.shape == want.shape == (N, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if k:
        base = cf.create_counterfactual_dataset(model, clf, setup["records"], [], 0)
        assert np.abs(got - base).max() > 1e-3


def _shared_features(x):
    x = np.asarray(x, np.float64)
    return np.stack([x[..., 0].mean(axis=(1, 2)), x[..., 1].mean(axis=(1, 2)),
                     x[..., 2].std(axis=(1, 2)), x[:, :16, :16].mean(axis=(1, 2, 3))], axis=1)


def test_fid_topk_matches_jax(setup, tmp_path):
    model, clf = setup["port"]
    modules, params, clf_j = setup["jax"]
    picks = setup["strong"][:3]
    ours = cf.fid_topk(model, clf, setup["records"], picks, k=3, batch_size=4,
                       csv_path=str(tmp_path / "port" / "fid_results.csv"),
                       feature_fn=lambda x: torch.from_numpy(
                           _shared_features(x.numpy().transpose(0, 2, 3, 1))))
    theirs = jcf.fid_topk(modules, params, clf_j, setup["jrecords"], picks, k=3, batch_size=4,
                          csv_path=str(tmp_path / "jax" / "fid_results.csv"),
                          feature_fn=lambda x: jnp.asarray(_shared_features(np.asarray(x))))
    assert len(ours) == 4 and all(np.isfinite(ours))
    np.testing.assert_allclose(ours, theirs, rtol=1e-3)
    rows = [list(csv.reader(open(tmp_path / p / "fid_results.csv"))) for p in ("port", "jax")]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]] == ["k", "generated", "1", "2", "3"]
    np.testing.assert_allclose([float(r[1]) for r in rows[0][1:]],
                               [float(r[1]) for r in rows[1][1:]], rtol=1e-3)
