"""The port's Google StylEx generator against the JAX package's, on the CPU.

The 16-px spec of the JAX package's ingestion tests (channels {4: 32, 8:
16, 16: 8}, dlatent 20), float32. The JAX generator's seeded weights are
carried into the port by ``google_generator_from_jax``; ``synthesize`` and
``call_synthesis`` then agree with and without a ``style_delta``, on the
fused and on the literal resample graph (the JAX policy is read when its
Python runs, so each JAX call is made inside the environment its test
sets), to 1e-5 x max|image|: XLA and PyTorch sum the CPU convolutions in
other orders. The structure (channel schedule, conv and to-RGB specs,
StyleSpace widths and indexing) is equal exactly, at the 16-px spec and at
the published 256-px defaults. The upsample's calls per forward are
counted on the CPU by wrapping its dispatch, against the count derived
from the structure that ``chip_smoke.py`` holds the kernel's launches to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.models import google_stylex as jg
from stylex_tpu_torch.models import google_stylex as tg
from stylex_tpu_torch.models.convert import google_generator_from_jax
from stylex_tpu_torch.ops import blur as tblur

torch.set_num_threads(2)

ENV = "STYLEX_TPU_NO_FUSED_UPCONV"
REL = 1e-5
JSPEC = jg.GoogleStylExGenerator(image_size=16, dlatent_dim=20,
                                 channels_map=((4, 32), (8, 16), (16, 8)))


@pytest.fixture(scope="module")
def carried():
    params = jax.tree.map(np.asarray, JSPEC.init_params(jax.random.PRNGKey(0)))
    return params, google_generator_from_jax(params, JSPEC, device="cpu")


def _inputs(seed=0, b=3):
    rng = np.random.RandomState(seed)
    w = rng.randn(b, JSPEC.dlatent_dim).astype(np.float32)
    delta = np.zeros((b, JSPEC.total_style_coords), np.float32)
    for i, s in enumerate((3, 40, 100)[:b]):
        delta[i, s] = 2.5 * (i + 1)
    return w, delta


def _close(got_nchw, want_nhwc):
    want = np.asarray(want_nhwc)
    got = got_nchw.detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * float(np.abs(want).max()))


def test_structure_matches_jax():
    for jspec, tspec in ((JSPEC, tg.GoogleStylExSpec(image_size=16, dlatent_dim=20,
                                                     channels_map=JSPEC.channels_map)),
                         (jg.GoogleStylExGenerator(), tg.GoogleStylExSpec())):
        for attr in ("channels", "resolutions", "num_layers", "conv_specs", "torgb_specs",
                     "layer_shapes", "total_style_coords"):
            assert getattr(tspec, attr) == getattr(jspec, attr), attr
        for s in (0, 1, jspec.total_style_coords // 2, jspec.total_style_coords - 1):
            assert tspec.sindex_to_layer_and_index(s) == jspec.sindex_to_layer_and_index(s)
    assert tg.GoogleStylExSpec().layer_shapes == [512] * 8 + [256, 256, 128, 128, 64]
    assert tg.GoogleStylExSpec().total_style_coords == 4928
    for size, base in ((256, 8192), (64, 2048), (1024, 32768)):
        assert tg.google_channels(size, base) == jg.google_channels(size, base)
    for shapes, s in (([32, 32, 16, 16, 8], 33), ([4, 1], 4), ([7], 0)):
        assert tg.sindex_to_layer_and_index(shapes, s) == jg.sindex_to_layer_and_index(shapes, s)
    with pytest.raises(IndexError):
        tg.sindex_to_layer_and_index([4, 4], 8)


def test_carried_weights_layout(carried):
    params, gen = carried
    sd = gen.state_dict()
    np.testing.assert_array_equal(sd["const"].numpy(), params["const"].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(sd["convs.2.weight"].numpy(),
                                  params["convs"][2]["weight"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["torgbs.1.style_kernel"].numpy(),
                                  params["torgbs"][1]["style_kernel"])
    assert gen.spec.channels == JSPEC.channels and gen.total_style_coords == 104


@pytest.mark.parametrize("graph", ["fused", "literal"])
def test_synthesis_matches_jax(carried, monkeypatch, graph):
    params, gen = carried
    monkeypatch.setenv(ENV, "0" if graph == "fused" else "1")
    w, delta = _inputs()
    jp = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        for d in (None, delta):
            want = JSPEC.synthesize(jp, jnp.asarray(w),
                                    style_delta=None if d is None else jnp.asarray(d))
            got = gen.synthesize(torch.from_numpy(w),
                                 None if d is None else torch.from_numpy(d))
            _close(got, want)
        tiled = np.tile(w[:, None], (1, JSPEC.num_layers, 1))
        want = JSPEC.call_synthesis(jp, jnp.asarray(tiled), style_delta=jnp.asarray(delta))
        got = gen.call_synthesis(torch.from_numpy(tiled), torch.from_numpy(delta))
        _close(got, want)
        assert float(got.abs().max()) <= 1.0
        conv_j, rgb_j = JSPEC.style_vectors(jp, jnp.asarray(w))
        conv_t, rgb_t = gen.style_vectors(torch.from_numpy(w))
        for a, b in zip(conv_t + rgb_t, conv_j + rgb_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_style_delta_zero_is_the_base_and_one_hot_moves_it(carried):
    _, gen = carried
    w, _ = _inputs()
    w = torch.from_numpy(w)
    with torch.no_grad():
        base = gen.synthesize(w)
        assert torch.equal(gen.synthesize(w, torch.zeros(3, gen.total_style_coords)), base)
        for s in (0, 40, gen.total_style_coords - 1):
            delta = torch.zeros(3, gen.total_style_coords)
            delta[:, s] = 3.0
            assert not torch.equal(gen.synthesize(w, delta), base), s


def _expected_upsample_calls(spec, fused: bool) -> int:
    """The upsample's calls per forward: one on the RGB skip per resolution
    above 4 px, and per block entry four border strips on the fused graph
    (input of 3x3 or more) or one literal upsample."""
    calls = 0
    for res in spec.resolutions[1:]:
        entry_in = res // 2
        calls += 1 + (4 if fused and entry_in >= 3 else 1)
    return calls


@pytest.mark.parametrize("graph", ["fused", "literal"])
def test_upsample_calls_per_forward(carried, monkeypatch, graph):
    _, gen = carried
    monkeypatch.setenv(ENV, "0" if graph == "fused" else "1")
    calls = []
    forward, plain = tblur._OPS["upsample2x_bilinear"]

    def counted(x):
        calls.append(tuple(x.shape))
        return forward(x)

    monkeypatch.setitem(tblur._OPS, "upsample2x_bilinear", (counted, plain))
    with torch.no_grad():
        gen.synthesize(torch.from_numpy(_inputs()[0]))
    assert len(calls) == _expected_upsample_calls(gen.spec, graph == "fused")
    assert _expected_upsample_calls(tg.GoogleStylExSpec(), True) == 30
    assert _expected_upsample_calls(tg.GoogleStylExSpec(), False) == 12


def test_seeded_init_save_load_and_bf16(tmp_path):
    spec = tg.GoogleStylExSpec(image_size=16, dlatent_dim=20, channels_map=JSPEC.channels_map)
    a = tg.GoogleStylExGenerator(spec, seed=3, device="cpu")
    b = tg.GoogleStylExGenerator(spec, seed=3, device="cpu")
    c = tg.GoogleStylExGenerator(spec, seed=4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert not torch.equal(a.convs[0].weight, c.convs[0].weight)
    path = tg.save_google_generator(str(tmp_path / "g.pt"), spec, a)
    spec2, loaded = tg.load_google_generator(path, device="cpu")
    assert spec2 == spec
    w = torch.randn(2, 20, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(loaded.synthesize(w), a.synthesize(w))
        img16 = a.synthesize(w.to(torch.bfloat16))
    assert img16.dtype == torch.bfloat16 and bool(torch.isfinite(img16).all())
