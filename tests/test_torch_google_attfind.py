"""AttFind on Google's StylEx generator from dlatents, on the CPU.

A 32-px spec (fmap_base 512, fmap_max 64: channels {4: 64, 8: 64, 16: 64,
32: 32}, 416 StyleSpace coordinates in blocks of 64, 128, 128 and 96),
seeded weights with style biases near 1, MobileNetV2 at 32 px. The
resumed synthesis equals the full forward bit for bit at every block; the
sweep's records, resumed and flat, match the benchmark's plain reference
(``benchmark/reference/google.py``: per-sample modulated weights and
grouped convolutions, where the port scales the input and demodulates the
output), each tolerance with its reason; the extremes come from
``style_range`` or the call's own dlatents; the spans and the
``attfind.styles`` counter; ``run_attfind --google-generator``; a
resumed sweep's upsample calls against the count ``chip_smoke.py``
derives from the code.
"""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import google as ref  # noqa: E402
from benchmark.reference import nets  # noqa: E402
from stylex_tpu_torch import run_attfind  # noqa: E402
from stylex_tpu_torch.attfind import rank_styles  # noqa: E402
from stylex_tpu_torch.attfind.extraction import attfind_extraction  # noqa: E402
from stylex_tpu_torch.models import build_classifier  # noqa: E402
from stylex_tpu_torch.models.google_stylex import (  # noqa: E402
    GoogleStylExGenerator,
    GoogleStylExSpec,
    save_google_generator,
)
from stylex_tpu_torch.ops.fusion import prefer_literal_resample  # noqa: E402
from stylex_tpu_torch.utils import tracing  # noqa: E402

torch.set_num_threads(2)

CFG = dict(image_size=32, dlatent_dim=514, fmap_base=512, fmap_max=64, num_classes=2)
SPEC = GoogleStylExSpec(image_size=32, dlatent_dim=514, fmap_base=512, fmap_max=64)


@pytest.fixture(scope="module")
def nets_():
    gen = GoogleStylExGenerator(SPEC, seed=3, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():  # a trained model's biases are not the init's
        for name, p in gen.named_parameters():
            if name.endswith("style_bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith(".bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    clf = build_classifier("mobilenet", 32, seed=5, device="cpu")
    return gen.eval(), clf


def _dlatents(n, seed=6):
    rng = np.random.RandomState(seed)
    z = rng.randn(n, 512).astype(np.float32)
    return np.concatenate([z, np.eye(2, dtype=np.float32)[rng.randint(0, 2, n)]], axis=1)


def _reference(gen, clf):
    rgen = ref.Generator(CFG)
    rgen.load_state_dict(gen.state_dict())
    rclf = nets.Classifier("mobilenet", 32, 2)
    rclf.net.load_state_dict(clf.net.state_dict())
    return rgen.eval(), rclf.eval()


def test_the_spec_blocks_are_the_resolutions():
    assert SPEC.block_sizes == [64, 128, 128, 96] == ref.block_sizes(CFG)
    assert GoogleStylExSpec().block_sizes == [512, 1024, 1024, 1024, 768, 384, 192]
    assert sum(GoogleStylExSpec().block_sizes) == 4928


@pytest.mark.parametrize("literal", [False, True], ids=["fused", "literal"])
def test_resumed_synthesis_equals_the_full_forward_at_every_block(nets_, literal):
    gen, _ = nets_
    w = torch.from_numpy(_dlatents(1))
    zero = torch.zeros(1, SPEC.total_style_coords)
    with torch.no_grad(), (prefer_literal_resample() if literal else contextlib.nullcontext()):
        full, states = gen.synthesize(w, capture_states=True)
        assert len(states) == len(SPEC.resolutions)
        assert torch.equal(full, gen.synthesize(w))
        for k, state in enumerate(states):
            assert torch.equal(gen.synthesize(w, zero, start_block=k, initial_state=state), full)
    with pytest.raises(ValueError):
        gen.synthesize(w, start_block=2)


def _sweep(gen, clf, dlatents, **kw):
    return attfind_extraction(gen, clf.classify_images, dlatents, coord_batch=96,
                              progress=False, **kw)


@pytest.fixture(scope="module")
def swept(nets_):
    gen, clf = nets_
    dl = _dlatents(5)
    rgen, rclf = _reference(gen, clf)
    lo, hi = ref.style_range(rgen, torch.from_numpy(dl))
    style_range = (lo.numpy(), hi.numpy())
    with tracing.recording():
        tracing.reset()
        resumed = _sweep(gen, clf, dl[:2], style_range=style_range, chunks_per_dispatch=3)
        snap = tracing.snapshot()
    tracing.reset()
    flat = _sweep(gen, clf, dl[:2], style_range=style_range, block_resume=False)
    return dict(dl=dl, range=(lo, hi), resumed=resumed, flat=flat, snap=snap,
                ref=(rgen, rclf))


@pytest.mark.parametrize("n,coord_batch", [(1, 96), (2, 100)])
def test_a_resumed_sweep_makes_the_upsample_calls_derived_from_the_code(nets_, monkeypatch, n,
                                                                       coord_batch):
    import chip_smoke
    from stylex_tpu_torch.ops import blur

    gen, clf = nets_
    calls = []
    forward, plain = blur._OPS["upsample2x_bilinear"]

    def counted(x):
        calls.append(tuple(x.shape))
        return forward(x)

    monkeypatch.setitem(blur._OPS, "upsample2x_bilinear", (counted, plain))
    attfind_extraction(gen, clf.classify_images, _dlatents(n), coord_batch=coord_batch,
                       progress=False)
    assert len(calls) == chip_smoke.google_sweep_upsample_calls(SPEC, n, coord_batch)
    # the 256-px cell's sweep of one dlatent: 12 in phase 1, 172 in its 20 chunks
    assert chip_smoke.google_sweep_upsample_calls(GoogleStylExSpec(), 1, 512) == 184


def test_records_match_the_plain_reference_resumed_and_flat(swept):
    rgen, rclf = swept["ref"]
    w = torch.from_numpy(swept["dl"][:2])
    coords, images, base = ref.phase1(rgen, rclf, w)
    C = SPEC.total_style_coords
    img = torch.arange(2).repeat_interleave(2 * C)
    is_max = torch.tensor([False, True]).repeat_interleave(C).repeat(2)
    coord = torch.arange(C).repeat(4)
    eff = ref.effects(rgen, rclf, w, coords, base, *swept["range"], img, coord, is_max,
                      batch=416).reshape(2, 2, C, 2).numpy()
    perturbed = np.abs(eff + base.numpy()[:, None, None, :]).max()
    for rec in (swept["resumed"], swept["flat"]):
        assert rec.style_change.shape == (2, 2, C, 2)
        np.testing.assert_array_equal(rec.latents, swept["dl"][:2])
        # the same affine, the same products: equal but for the order of a sum
        np.testing.assert_allclose(rec.style_coordinates, coords.numpy(), rtol=0,
                                   atol=1e-6 * np.abs(coords.numpy()).max())
        # the modulated convs factorised two ways (input scaled and output
        # demodulated, against per-sample weights): float32 rounding of
        # 1e-7 a layer over 7 convs and the classifier
        np.testing.assert_allclose(rec.original_images, images.permute(0, 2, 3, 1).numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(rec.base_prob, base.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(base.numpy()).max())
        # a logit change is a difference of two such logits
        np.testing.assert_allclose(rec.style_change, eff, rtol=0, atol=1e-5 * perturbed)
        assert np.isnan(rec.discriminator).all() and rec.discriminator.shape == (2, 1)
        assert rec.noise.shape == (1, 32, 32, 1)
    # the resumed sweep runs the same arithmetic from cached states, in
    # chunks that group other perturbations: the CPU's convolutions round
    # by batch (2.4e-6 at most here)
    np.testing.assert_allclose(swept["resumed"].style_change, swept["flat"].style_change,
                               rtol=0, atol=1e-5 * perturbed)
    ranked, _ = rank_styles(swept["resumed"], num_classes=2, num_indices=3)
    assert 0 < len(ranked) <= 3 and all(0 <= s < C for _, s in ranked)


def test_the_extremes_come_from_the_range_or_from_the_call(swept, nets_):
    lo, hi = swept["range"]
    rec = swept["resumed"]
    np.testing.assert_array_equal(rec.minima, lo.numpy())
    np.testing.assert_array_equal(rec.maxima, hi.numpy())
    # the pool's range is wider than that of the call's two dlatents
    assert (rec.minima <= rec.style_coordinates.min(0)).all()
    assert (rec.minima < rec.style_coordinates.min(0)).any()
    gen, clf = nets_
    own = _sweep(gen, clf, swept["dl"][:2], block_resume=False)
    np.testing.assert_array_equal(own.minima, own.style_coordinates.min(0))
    np.testing.assert_array_equal(own.maxima, own.style_coordinates.max(0))
    with pytest.raises(ValueError):
        _sweep(gen, clf, swept["dl"][:2], use_discriminator=True, discriminator_threshold=0.0)


def test_spans_name_each_resolution_and_the_counter_every_style(swept):
    spans = swept["snap"]["spans"]
    names = [s["name"] for s in spans]
    for name in ("attfind.call", "attfind.phase1", "attfind.capture", "attfind.records"):
        assert names.count(name) == 1, name
    blocks = [s for s in spans if s["name"] == "attfind.block"]
    assert [b["unit"] for b in blocks] == [0, 1, 2, 3]
    assert [b["attrs"]["res"] for b in blocks] == SPEC.resolutions
    assert [b["attrs"]["styles"] for b in blocks] == [2 * 2 * n for n in SPEC.block_sizes]
    # chunks of 96 a block, copies of 3 chunks
    chunks = [-(-4 * n // 96) for n in SPEC.block_sizes]
    assert names.count("attfind.chunk") == sum(chunks)
    assert names.count("attfind.copy") == sum(-(-c // 3) for c in chunks)
    assert names.count("attfind.wait") == 0  # no device to wait for on the CPU
    assert swept["snap"]["counters"]["attfind.styles"] == 2 * 2 * SPEC.total_style_coords


def test_run_attfind_sweeps_a_saved_google_generator(tmp_path, nets_, swept):
    gen, _ = nets_
    save_google_generator(str(tmp_path / "g.pt"), SPEC, gen)
    np.save(tmp_path / "d.npy", swept["dl"])
    out = tmp_path / "res"
    summary = run_attfind.main(["--google-generator", str(tmp_path / "g.pt"),
                                "--dlatents", str(tmp_path / "d.npy"), "--device", "cpu",
                                "--classifier-name", "mobilenet", "--num-images", "2",
                                "--coord-batch", "208", "--results-folder", str(out)])
    assert summary[0]["styles"] == 2 * 2 * SPEC.total_style_coords
    from stylex_tpu_torch.attfind import load_records

    files = sorted(p.name for p in out.iterdir())
    assert "top_styles.json" in files
    rec = load_records(str(out / next(f for f in files if f.startswith("style_change_records"))))
    np.testing.assert_array_equal(rec.latents, swept["dl"][:2])
    # the range is over every dlatent given, not only the two swept
    coords = torch.cat(gen.style_vectors(torch.from_numpy(swept["dl"]))[0], dim=-1)
    np.testing.assert_allclose(rec.minima, coords.min(0).values.detach().numpy(), rtol=1e-6)
    top = json.loads((out / "top_styles.json").read_text())
    assert [list(SPEC.sindex_to_layer_and_index(s)) for _, s in top["ranked"]] == top["layers"]
    with pytest.raises(SystemExit):
        run_attfind.parse_args(["--google-generator", "g.pt"])


def test_the_stylex_sweep_counts_its_styles_and_names_its_resolutions():
    from stylex_tpu_torch.config import ModelConfig
    from stylex_tpu_torch.models import build_stylex

    cfg = ModelConfig(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)
    model = build_stylex(cfg, seed=0, device="cpu").eval()
    clf = build_classifier("mobilenet", 16, cfg.num_classes, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.random((2, 16, 16, 3), dtype=np.float32)
    noise = rng.random((1, 16, 16, 1), dtype=np.float32)
    with tracing.recording():
        tracing.reset()
        attfind_extraction(model, clf.classify_images, images, noise, coord_batch=64,
                           progress=False)
        snap = tracing.snapshot()
    tracing.reset()
    assert snap["counters"]["attfind.styles"] == 2 * 2 * model.total_style_coords
    blocks = [s for s in snap["spans"] if s["name"] == "attfind.block"]
    assert [(b["unit"], b["attrs"]["res"]) for b in blocks] == [(0, 4), (1, 8), (2, 16)]
    assert [b["attrs"]["styles"] for b in blocks] == [4 * (i + o) for i, o in model.G.block_dims]
