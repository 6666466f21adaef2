"""The port's AttFind slice against the JAX package's, on the CPU.

The same bridged weights, images and noise go through
``stylex_tpu.attfind.attfind_extraction`` and the port's, block-resume and
flat. Records match at atol 1e-4 (float32; convolutions sum in another
order) and ``rank_styles`` gives the identical top-k.

A randomly initialised classifier barely sees its input (logit changes of
~1e-5), so its head is scaled by 1e4 in both packages: the changes become
O(1) while the two packages still agree to ~5e-5. The image seed is one
whose ranking has margins wider than the tolerance: every greedy pick and
every merged score beats its runner-up, every image's class margin and
every image's distance from the greedy effect budget exceed it, by more
than twice the tolerance, so no tolerated difference can reorder the
ranking. The test asserts those margins.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from stylex_tpu.attfind import attfind_extraction as j_extraction
from stylex_tpu.attfind import find_discriminator_threshold as j_threshold
from stylex_tpu.attfind import load_records_hdf5 as j_load_records
from stylex_tpu.attfind import rank_styles as j_rank_styles
from stylex_tpu.config import ModelConfig as JModelConfig
from stylex_tpu.models import build_stylex as j_build_stylex, init_stylex_params
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu_torch.attfind import (
    attfind_extraction,
    find_discriminator_threshold,
    rank_styles,
    save_records_hdf5,
)
from stylex_tpu_torch.config import ModelConfig
from stylex_tpu_torch.models import build_classifier
from stylex_tpu_torch.models.convert import (
    classifier_state_dict_from_jax,
    stylex_state_dict_from_jax,
)
from stylex_tpu_torch.models.stylex import StylEx

torch.set_num_threads(2)

ATOL = 1e-4
FIELDS = ("style_change", "style_coordinates", "base_prob", "latents", "discriminator")
TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)
NUM_INDICES = 5
HEAD_SCALE = 1e4


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(**TINY)
    modules = j_build_stylex(jcfg)
    params = init_stylex_params(jax.random.PRNGKey(0), modules)
    clf_j = j_build_classifier("mobilenet", 16)
    variables = jax.tree.map(np.asarray, clf_j.variables)
    variables["params"]["classifier"]["kernel"] = variables["params"]["classifier"]["kernel"] * HEAD_SCALE
    clf_j.variables = jax.tree.map(jax.numpy.asarray, variables)
    cfg = ModelConfig(**TINY)
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg))
    clf = build_classifier("mobilenet", 16, device="cpu")
    clf.net.load_state_dict(
        classifier_state_dict_from_jax(variables, "mobilenet"))
    rng = np.random.RandomState(4)
    images = rng.rand(6, 16, 16, 3).astype(np.float32)
    noise = rng.rand(1, 16, 16, 1).astype(np.float32)
    return (modules, params, clf_j.classify_images), (model.eval(), clf.classify_images), images, noise


@pytest.fixture(scope="module")
def jax_records(setup):
    (modules, params, clf_j), _, images, noise = setup
    return j_extraction(modules, params, clf_j, images, noise, coord_batch=64, progress=False)


def _port(setup, **kw):
    _, (model, clf), images, noise = setup
    return attfind_extraction(model, clf, images, noise, coord_batch=64, progress=False, **kw)


def _greedy_margins(effect, class_index, num_indices, max_image_effect):
    """At every greedy step of ``find_significant_styles``: the gap between
    the pick and the runner-up, and the distance of the images' spent effect
    from the budget (per pick so far, since each pick adds its own error)."""
    n = effect.shape[0]
    e = np.maximum(0.0, effect[:, :, :, class_index]).reshape(n, -1)
    spent = np.zeros(n)
    margins = []
    for step in range(min(num_indices, e.shape[1])):
        active = spent < max_image_effect
        if not active.any():
            active[:] = True
        means = e[active].mean(axis=0)
        top2 = np.sort(means)[-2:]
        margins.append(top2[1] - top2[0])
        s = int(np.argmax(means))
        spent += e[:, s]
        e[:, s] = 0.0
        margins.append(np.abs(spent - max_image_effect).min() / (step + 1))
    return margins


def _assert_ranking_margins(rec):
    assert np.abs(rec.base_prob[:, 0] - rec.base_prob[:, 1]).min() > 2 * ATOL
    labels = rec.base_prob.argmax(axis=1)
    assert set(labels) == {0, 1}  # both classes' picks reach the merge
    ranked, per_class = j_rank_styles(rec, num_indices=NUM_INDICES)
    for cls in (0, 1):
        # rank_styles' budget: effect_threshold (0.5) * 5
        assert min(_greedy_margins(rec.style_change[labels == cls], cls, NUM_INDICES, 2.5)) > 2 * ATOL
    sindex0 = {s for _, s in per_class[0]}
    joined = [(1 - d, s) for d, s in per_class[1] if s not in sindex0] + per_class[0]
    scores = sorted(float(rec.style_change[:, d, s, 0].mean() + rec.style_change[:, 1 - d, s, 1].mean())
                    for d, s in joined)
    assert min(np.diff(scores)) > 2 * ATOL
    return ranked


@pytest.mark.parametrize("block_resume", [True, False])
def test_extraction_matches_jax(setup, jax_records, block_resume):
    rec = _port(setup, block_resume=block_resume)
    for f in FIELDS:
        got, want = getattr(rec, f), getattr(jax_records, f)
        assert got.shape == want.shape and got.dtype == np.float32, f
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(rec.minima, jax_records.minima, rtol=0, atol=ATOL)
    np.testing.assert_allclose(rec.maxima, jax_records.maxima, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rec.original_images, jax_records.original_images)
    want_ranked = _assert_ranking_margins(jax_records)
    ranked, per_class = rank_styles(rec, num_indices=NUM_INDICES)
    assert ranked == want_ranked and len(ranked) == NUM_INDICES
    assert per_class == j_rank_styles(jax_records, num_indices=NUM_INDICES)[1]
    assert set(rec.stage_walls) >= {"phase1", "records_fetch"}


def test_resume_and_flat_agree(setup):
    a = _port(setup, block_resume=True)
    b = _port(setup, block_resume=False)
    np.testing.assert_allclose(a.style_change, b.style_change, rtol=1e-5, atol=1e-6)


def test_hdf5_written_by_port_reads_in_jax(setup, tmp_path):
    rec = _port(setup)
    path = save_records_hdf5(rec, str(tmp_path / "style_change_records.hdf5"))
    back = j_load_records(path)
    for f in dataclasses.fields(rec):
        if f.name != "stage_walls":
            np.testing.assert_array_equal(getattr(back, f.name), getattr(rec, f.name), f.name)


@pytest.mark.parametrize("block_resume", [True, False])
def test_discriminator_filter_matches_jax(setup, block_resume):
    (modules, params, clf_j), (model, clf), images, noise = setup
    scores = find_discriminator_threshold(model, clf, images, noise, phase1_batch=4)
    np.testing.assert_allclose(scores, j_threshold(modules, params, clf_j, images, noise,
                                                   phase1_batch=4), rtol=0, atol=ATOL)
    thr = float(np.median(scores))
    kw = dict(discriminator_threshold=thr, use_discriminator=True, num_images=2,
              block_resume=block_resume)
    rec = _port(setup, **kw)
    want = j_extraction(modules, params, clf_j, images, noise, coord_batch=64,
                        progress=False, **kw)
    assert rec.style_change.shape[0] == 2
    assert (rec.discriminator < thr).all()
    for f in FIELDS + ("minima", "maxima"):
        np.testing.assert_allclose(getattr(rec, f), getattr(want, f), rtol=0, atol=ATOL,
                                   err_msg=f)
    np.testing.assert_array_equal(rec.original_images, want.original_images)


def test_bf16_extraction_runs_and_tracks_f32(setup, jax_records):
    """compute_dtype=bfloat16: float32 records of the same shapes, with mean
    effects that track the float32 sweep. bf16 keeps ~3 significant digits
    and rounds at every layer of ~60, so the bound is loose: agreement to a
    quarter of the effects' range and a correlation above 0.9."""
    _, (model, clf), images, noise = setup
    model16 = StylEx(model.cfg)
    model16.load_state_dict(model.state_dict())
    model16 = model16.to(torch.bfloat16).eval()
    bundle = clf.__self__
    net32 = bundle.net
    bundle.net = type(net32)().eval()
    bundle.net.load_state_dict(net32.state_dict())
    bundle.net.to(torch.bfloat16)
    try:
        rec = attfind_extraction(model16, bundle.classify_images, images, noise,
                                 coord_batch=64, progress=False, compute_dtype="bfloat16")
    finally:
        bundle.net = net32
    assert rec.style_change.dtype == np.float32
    assert rec.style_change.shape == jax_records.style_change.shape
    m16, m32 = rec.style_change.mean(axis=0), jax_records.style_change.mean(axis=0)
    assert np.isfinite(m16).all()
    np.testing.assert_allclose(m16, m32, rtol=0, atol=0.25 * np.abs(m32).max())
    assert np.corrcoef(m16.ravel(), m32.ravel())[0, 1] > 0.9
