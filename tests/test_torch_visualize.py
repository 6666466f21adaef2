"""The port's counterfactual panels against the JAX package's, on the CPU.

The same carried weights and records go through both packages' panel
functions: the same images are chosen, the panels have the same shape, and
their pixels (captions included) lie within 1 uint8 level. The
classifier's head is scaled so that its probabilities move with the
shifts, which makes the realized-change check choose.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.attfind import visualize as jvis
from stylex_tpu.attfind.extraction import AttFindRecords as JRecords
from stylex_tpu.config import ModelConfig as JModelConfig
from stylex_tpu.models import build_stylex as j_build_stylex, init_stylex_params
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu_torch.attfind import AttFindRecords
from stylex_tpu_torch.attfind import visualize as vis
from stylex_tpu_torch.config import ModelConfig
from stylex_tpu_torch.models import build_classifier
from stylex_tpu_torch.models.convert import (
    classifier_state_dict_from_jax,
    stylex_state_dict_from_jax,
)
from stylex_tpu_torch.models.stylex import StylEx

torch.set_num_threads(2)

TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)
N = 12
HEAD_SCALE = 2000.0


@pytest.fixture(scope="module")
def setup():
    modules = j_build_stylex(JModelConfig(**TINY))
    params = init_stylex_params(jax.random.PRNGKey(2), modules)
    clf_j = j_build_classifier("mobilenet", 16)
    variables = jax.tree.map(np.asarray, clf_j.variables)
    variables["params"]["classifier"]["kernel"] = (
        variables["params"]["classifier"]["kernel"] * HEAD_SCALE)
    clf_j.variables = jax.tree.map(jnp.asarray, variables)
    cfg = ModelConfig(**TINY)
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg))
    clf = build_classifier("mobilenet", 16, device="cpu")
    clf.net.load_state_dict(classifier_state_dict_from_jax(variables, "mobilenet"))

    C = model.total_style_coords
    rng = np.random.RandomState(6)
    coords = (rng.randn(N, C) * 2.0).astype(np.float32)
    style_change = rng.uniform(-0.3, 0.6, (N, 2, C, 2)).astype(np.float32)
    fields = dict(
        style_change=style_change,
        latents=rng.randn(N, cfg.latent_dim).astype(np.float32),
        base_prob=rng.randn(N, 2).astype(np.float32),
        minima=coords.min(0) - 2.0,
        maxima=coords.max(0) + 2.0,
        style_coordinates=coords,
        original_images=rng.rand(N, 16, 16, 3).astype(np.float32),
        noise=rng.rand(1, 16, 16, 1).astype(np.float32),
        discriminator=np.zeros((N, 1), np.float32),
    )
    return (modules, params, clf_j.classify_images), (model.eval(), clf.classify_images), \
        AttFindRecords(**fields), JRecords(**fields)


def _assert_panels_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("image_index", [None, 3])
def test_change_image_matches_jax(setup, image_index):
    (modules, params, clf_j), (model, clf), rec, jrec = setup
    args = (rec.latents[2], rec.noise)
    img, prob = vis.generate_change_image_given_dlatent(
        model, clf, *args, rec, 17, 1, class_index=1, image_index=image_index)
    jimg, jprob = jvis.generate_change_image_given_dlatent(
        modules, params, clf_j, *args, jrec, 17, 1, class_index=1, image_index=image_index)
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-4)
    assert abs(prob - jprob) < 1e-4


@pytest.mark.parametrize("draw_probs", [False, True])
def test_panel_matches_jax(setup, draw_probs):
    (modules, params, clf_j), (model, clf), rec, jrec = setup
    got = vis.generate_images_given_dlatent(model, clf, rec.latents[5], rec.noise, rec, 40, 0,
                                            image_index=5, draw_probs=draw_probs,
                                            return_probs=True)
    want = jvis.generate_images_given_dlatent(modules, params, clf_j, rec.latents[5], rec.noise,
                                              jrec, 40, 0, image_index=5,
                                              draw_probs=draw_probs, return_probs=True)
    _assert_panels_close(got[0], want[0])
    assert got[0].shape == (16 + 12 * draw_probs, 32, 3)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("sindex,direction,both", [(40, 0, False), (9, 1, False), (40, 1, True)])
def test_visualize_style_matches_jax(setup, sindex, direction, both):
    """The seeded shuffle, the over-sampling and the realized-change check
    keep the same images in both packages."""
    (modules, params, clf_j), (model, clf), rec, jrec = setup
    kw = dict(effect_threshold=0.05, max_images=3, min_images=1, seed=4,
              allow_both_directions_change=both)
    got = vis.visualize_style(model, clf, rec, sindex, direction, **kw)
    want = jvis.visualize_style(modules, params, clf_j, jrec, sindex, direction, **kw)
    assert got is not None and want is not None
    _assert_panels_close(got, want)
    # a threshold that no realized change reaches: no panel in either
    kw["effect_threshold"] = 0.5
    assert vis.visualize_style(model, clf, rec, sindex, direction, **kw) is None
    assert jvis.visualize_style(modules, params, clf_j, jrec, sindex, direction, **kw) is None


def test_visualize_by_distance_matches_jax(setup):
    (modules, params, clf_j), (model, clf), rec, jrec = setup
    got = vis.visualize_style_by_distance_in_s(model, clf, rec, 21, 1, max_images=4)
    want = jvis.visualize_style_by_distance_in_s(modules, params, clf_j, jrec, 21, 1,
                                                 max_images=4)
    assert got.shape == (4 * (16 + 12), 32, 3)
    _assert_panels_close(got, want)
