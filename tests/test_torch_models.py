"""The port's networks against the JAX package's, on the CPU.

JAX parameters initialised from a seed go through the weight bridge
(``stylex_state_dict_from_jax`` / ``classifier_state_dict_from_jax``) into
the port; the same numpy inputs go through both. float32, rtol 1e-4 /
atol 1e-5: the convolutions sum in another order. The JAX generator runs
its literal resample graph, the one the port implements.

The port also loads the reference-layout state dicts of
``tests/golden/convert_spec_v1.json`` directly and matches the frozen torch
oracle outputs at that file's tolerances.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.config import Arch as JArch, ModelConfig as JModelConfig
from stylex_tpu.models import build_stylex as j_build_stylex, init_stylex_params
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu.ops.fusion import prefer_literal_resample
from stylex_tpu.ops.latents import expand_styles as j_expand
from stylex_tpu_torch.config import Arch, ModelConfig
from stylex_tpu_torch.models import MobileNetV2, ResNet18, build_classifier
from stylex_tpu_torch.models.convert import (
    classifier_state_dict_from_jax,
    stylex_state_dict_from_jax,
)
from stylex_tpu_torch.models.stylex import StylEx

from test_convert_fixtures import CAP, ENC, IMAGE_SIZE, LATENT, OUT_PATH, SPEC_PATH
from test_convert_fixtures import fixed_inputs, synth_state_dict

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _pair(arch):
    jcfg = JModelConfig(arch=JArch(arch), **TINY)
    modules = j_build_stylex(jcfg)
    params = init_stylex_params(jax.random.PRNGKey(0), modules)
    cfg = ModelConfig(arch=Arch(arch), **TINY)
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(_np_tree(params), cfg))
    return modules, params, model.eval()


@pytest.fixture(scope="module")
def old_pair():
    return _pair("old")


def _inputs(seed=0, batch=3):
    rng = np.random.RandomState(seed)
    return {
        "z": rng.randn(batch, LATENT).astype(np.float32),
        "w": rng.randn(batch, LATENT).astype(np.float32),
        "noise": rng.rand(1, 16, 16, 1).astype(np.float32),
        "x": rng.rand(batch, 16, 16, 3).astype(np.float32),
        "delta": (rng.randn(batch, 136) * 0.5).astype(np.float32),
    }


def test_mapping_matches_jax(old_pair):
    modules, params, model = old_pair
    z = _inputs()["z"]
    with torch.no_grad():
        _close(model.map_z(torch.from_numpy(z)), modules.map_z(params, jnp.asarray(z)))
        _close(model.map_z(torch.from_numpy(z), ema=True),
               modules.map_z(params, jnp.asarray(z), ema=True))


@pytest.mark.parametrize("with_delta", [False, True])
def test_generator_matches_jax(old_pair, with_delta):
    modules, params, model = old_pair
    inp = _inputs(1)
    L = modules.num_layers
    delta = inp["delta"] if with_delta else None
    with prefer_literal_resample():
        rgb_j, coords_j, states_j = modules.generate(
            params, j_expand(jnp.asarray(inp["w"]), L), jnp.asarray(inp["noise"]),
            style_delta=None if delta is None else jnp.asarray(delta), capture_states=True,
        )
    with torch.no_grad():
        rgb, coords, states = model.generate(
            torch.from_numpy(inp["w"])[:, None].expand(-1, L, -1),
            torch.from_numpy(inp["noise"]),
            style_delta=None if delta is None else torch.from_numpy(delta),
            capture_states=True,
        )
    _close(_nhwc(rgb), rgb_j)
    _close(coords, coords_j)
    assert len(states) == len(states_j)
    for (x, r), (xj, rj) in zip(states, states_j):
        _close(_nhwc(x), xj)
        assert (r is None) == (rj is None)
        if r is not None:
            _close(_nhwc(r), rj)


@pytest.mark.parametrize("start_block", [0, 1, 2])
def test_generator_resume_matches_jax(old_pair, start_block):
    """Resuming at block k from JAX's captured entry state gives JAX's output."""
    modules, params, model = old_pair
    inp = _inputs(2)
    L = modules.num_layers
    w_j = j_expand(jnp.asarray(inp["w"]), L)
    with prefer_literal_resample():
        _, _, states_j = modules.generate(params, w_j, jnp.asarray(inp["noise"]),
                                          capture_states=True)
        xj, rj = states_j[start_block]
        rgb_j, coords_j = modules.generate(
            params, w_j, jnp.asarray(inp["noise"]), style_delta=jnp.asarray(inp["delta"]),
            start_block=start_block, initial_state=(xj, rj),
        )
    with torch.no_grad():
        rgb, coords = model.generate(
            torch.from_numpy(inp["w"])[:, None].expand(-1, L, -1),
            torch.from_numpy(inp["noise"]), style_delta=torch.from_numpy(inp["delta"]),
            start_block=start_block,
            initial_state=(_nchw(xj), None if rj is None else _nchw(rj)),
        )
    _close(_nhwc(rgb), rgb_j)
    _close(coords, coords_j)


def test_encoder_and_disc_match_jax(old_pair):
    modules, params, model = old_pair
    x = _inputs(3)["x"]
    with prefer_literal_resample(), torch.no_grad():
        _close(model.encode(_nchw(x)), modules.encode(params, jnp.asarray(x)))
        _close(model.discriminate(_nchw(x)), modules.discriminate(params, jnp.asarray(x)))


def test_cond_disc_matches_jax():
    modules, params, model = _pair("new")
    x = _inputs(4)["x"]
    probs = np.random.RandomState(5).dirichlet([1.0, 1.0], size=3).astype(np.float32)
    with prefer_literal_resample(), torch.no_grad():
        got = model.discriminate(_nchw(x), torch.from_numpy(probs))
        want = modules.discriminate(params, jnp.asarray(x), jnp.asarray(probs))
    assert got.shape == (3,)
    _close(got, want)


@pytest.mark.parametrize("kind", ["mobilenet", "resnet"])
def test_classifier_matches_jax(kind):
    bundle_j = j_build_classifier(kind, 16)
    bundle = build_classifier(kind, 16, device="cpu")
    bundle.net.load_state_dict(
        classifier_state_dict_from_jax(_np_tree(bundle_j.variables), kind))
    x = np.random.RandomState(6).rand(2, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        got = bundle.classify_images(_nchw(x))
    _close(got, bundle_j.classify_images(jnp.asarray(x)))


# ---------------------------------------------------------------- golden


@pytest.fixture(scope="module")
def golden():
    return json.loads(SPEC_PATH.read_text()), dict(np.load(OUT_PATH))


def _torch_sd(entries):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in synth_state_dict(entries).items()}


@pytest.mark.parametrize("kind", ["resnet18", "mobilenet_v2"])
def test_classifier_loads_reference_layout(golden, kind):
    spec, outs = golden
    net = (ResNet18() if kind == "resnet18" else MobileNetV2()).eval()
    net.load_state_dict(_torch_sd(spec[kind]))
    with torch.no_grad():
        got = net(_nchw(fixed_inputs()["clf_imgs"]))
    want = outs["resnet_logits" if kind == "resnet18" else "mobilenet_logits"]
    _close(got, want, rtol=1e-3, atol=1e-4)


def test_stylex_loads_reference_layout(golden):
    spec, outs = golden
    cfg = ModelConfig(image_size=IMAGE_SIZE, network_capacity=CAP, latent_dim=LATENT,
                      encoder_dim=ENC, style_depth=3)
    model = StylEx(cfg).eval()
    model.load_state_dict(_torch_sd(spec["stylex"]))
    inp = fixed_inputs()
    with torch.no_grad():
        _close(model.map_z(torch.from_numpy(inp["z"])), outs["s_w"], rtol=1e-4, atol=1e-5)
        rgb, coords = model.generate(torch.from_numpy(inp["w"]), torch.from_numpy(inp["inoise"]))
        _close(_nhwc(rgb), outs["g_rgb"], rtol=1e-3, atol=1e-4)
        _close(coords, outs["g_coords"], rtol=1e-3, atol=1e-4)
        x = _nchw(inp["x"])
        _close(model.discriminate(x), outs["d_out"], rtol=1e-3, atol=1e-4)
        _close(model.encode(x), outs["e_out"], rtol=1e-3, atol=1e-4)
