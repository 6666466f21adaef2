"""The port's TensorFlow ingestion against the JAX package's and against
TensorFlow itself, on the CPU.

Google's SavedModels cannot be fetched here, so the path runs against the
synthetic SavedModels of ``tests/tf_twin.py`` (the documented layout, the
JAX package's 16-px ingestion spec):

* the converter's module equals the JAX converter's tree carried by
  ``google_generator_from_jax``, bit for bit, and synthesises TF's images
  to 2e-4 (the JAX package's own tolerance against the twin: TF's resize
  and convolutions round in other orders);
* the Keras-renamed and the nested layouts convert to the same weights,
  and a layout without ``g_synthesis`` raises, pointing at
  ``describe_savedmodel``;
* the SavedModel's counterfactual by bias mutation equals the port's
  ``style_delta`` to 2e-4;
* ``load_examples_tfrecord`` parses a file that TF writes with no
  TensorFlow in the port's parser, equal to the JAX (TF-backed) function
  bit for bit, and refuses a corrupted record;
* ``google_fid_topk`` equals the JAX one with the same injected feature
  function to rtol 1e-3 (the FID of nearly equal images: the statistics
  are float64 on both sides), through the converted generators and through
  TF's mutation loop.
"""

import csv

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp
import torch

from stylex_tpu import ingest_tf as jingest
from stylex_tpu.models.google_stylex import GoogleStylExGenerator as JSpec
from stylex_tpu_torch import ingest_tf
from stylex_tpu_torch.models.convert import google_generator_from_jax

from tf_twin import (
    TwinGenerator,
    perturb_broken_layout,
    perturb_keras_layout,
    perturb_nested_layout,
    save_twins,
)

torch.set_num_threads(2)

SPEC = JSpec(image_size=16, dlatent_dim=20, channels_map=((4, 32), (8, 16), (16, 8)))
TOL = 2e-4


@pytest.fixture(scope="module")
def saved_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("google_stylex_torch")
    save_twins(root, SPEC, seed=3)
    return root


@pytest.fixture(scope="module")
def models(saved_root):
    return ingest_tf.GoogleStylExTF(saved_root, num_layers=SPEC.num_layers)


@pytest.fixture(scope="module")
def converted(saved_root):
    return ingest_tf.convert_google_generator(saved_root / "generator.savedmodel", device="cpu")


def _state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def test_describe_layer_shapes_and_sindex(saved_root, models):
    path = saved_root / "generator.savedmodel"
    assert ingest_tf.describe_savedmodel(path) == jingest.describe_savedmodel(path)
    assert models.layer_shapes == SPEC.layer_shapes == [32, 32, 16, 16, 8]
    for s in (0, 33, 103):
        assert models.sindex_to_layer_and_index(s) == SPEC.sindex_to_layer_and_index(s)


def test_convert_matches_jax_converter_and_tf(saved_root, models, converted):
    spec, gen = converted
    assert spec == gen.spec
    assert (spec.image_size, spec.dlatent_dim, spec.layer_shapes) == (
        SPEC.image_size, SPEC.dlatent_dim, SPEC.layer_shapes)
    jgen, jparams = jingest.convert_google_generator(saved_root / "generator.savedmodel")
    want = _state(google_generator_from_jax({k: (np.asarray(v) if k == "const" else
                                                 [{n: np.asarray(a) for n, a in p.items()}
                                                  for p in v])
                                             for k, v in jparams.items()}, jgen, device="cpu"))
    got = _state(gen)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    rng = np.random.RandomState(0)
    w = rng.randn(3, SPEC.dlatent_dim).astype(np.float32)
    tiled = np.tile(w[:, None, :], (1, SPEC.num_layers, 1))
    with torch.no_grad():
        img = gen.call_synthesis(torch.from_numpy(tiled)).numpy()  # NCHW
        conv_styles, _ = gen.style_vectors(torch.from_numpy(w))
    np.testing.assert_allclose(img, models.call_synthesis(tiled), rtol=0, atol=TOL)
    np.testing.assert_allclose(torch.cat(conv_styles, 1).numpy(), models.style_vectors(w),
                               rtol=0, atol=1e-4)


def test_convert_adapts_to_perturbed_layouts():
    twin = TwinGenerator(SPEC, seed=3)
    _, base = ingest_tf.convert_google_generator(twin, device="cpu")
    want = _state(base)
    for perturb in (perturb_keras_layout, perturb_nested_layout):
        spec, gen = ingest_tf.convert_google_generator(perturb(twin), device="cpu")
        assert spec.layer_shapes == SPEC.layer_shapes
        got = _state(gen)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{perturb.__name__} {k}")
    with pytest.raises(ValueError, match="describe_savedmodel"):
        ingest_tf.convert_google_generator(perturb_broken_layout(twin), device="cpu")


def test_counterfactual_mutation_equals_style_delta(models, converted):
    _, gen = converted
    rng = np.random.RandomState(1)
    latents = rng.randn(2, SPEC.dlatent_dim).astype(np.float32)
    sv = models.style_vectors(latents)
    style_min, style_max = sv.min(0), sv.max(0)
    picks = [(0, 5), (1, 40), (0, 100)]
    want = models.counterfactual_images(latents, picks, k=3, style_min=style_min,
                                        style_max=style_max, shift_size=1.0, batch_size=2)
    with torch.no_grad():
        base = gen.call_synthesis(torch.from_numpy(latents)).permute(0, 2, 3, 1).numpy()
    base_prob = models.classify(base)
    delta = np.zeros((2, gen.total_style_coords), np.float32)
    for bi in range(2):
        flip = int(np.argmax(base_prob[bi])) == 0
        for direction, sindex in picks:
            extreme = style_min[sindex] if (direction == 0) != flip else style_max[sindex]
            delta[bi, sindex] = extreme - sv[bi, sindex]
    with torch.no_grad():
        got = gen.call_synthesis(torch.from_numpy(latents), torch.from_numpy(delta))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=TOL)


def _write_examples(path, n, C, num_classes, seed):
    rng = np.random.RandomState(seed)
    with tf.io.TFRecordWriter(str(path)) as w:
        for i in range(n):
            feature = {
                "dlatent": tf.train.Feature(float_list=tf.train.FloatList(
                    value=rng.randn(20).astype(np.float32))),
                "result": tf.train.Feature(float_list=tf.train.FloatList(
                    value=rng.randn(C * 2 * num_classes).astype(np.float32))),
                "base_prob": tf.train.Feature(float_list=tf.train.FloatList(
                    value=rng.rand(num_classes).astype(np.float32))),
                "index": tf.train.Feature(int64_list=tf.train.Int64List(value=[i, -i, 2**40])),
                "name": tf.train.Feature(bytes_list=tf.train.BytesList(value=[b"img%d" % i])),
            }
            w.write(tf.train.Example(features=tf.train.Features(feature=feature))
                    .SerializeToString())


def test_load_examples_tfrecord_needs_no_tensorflow(tmp_path, monkeypatch):
    path = tmp_path / "examples_1.tfrecord"
    _write_examples(path, 5, 7, 2, seed=0)
    want = jingest.load_examples_tfrecord(path, 2)

    def no_tf():
        raise AssertionError("the TFRecord parser reached TensorFlow")

    monkeypatch.setattr(ingest_tf, "_tf", no_tf)
    got = ingest_tf.load_examples_tfrecord(path, 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (5, 2, 7, 2)
    first = ingest_tf.parse_example(next(ingest_tf.read_tfrecords(path)))
    assert first["index"].tolist() == [0, 0, 2**40] and first["name"] == [b"img0"]

    data = bytearray(path.read_bytes())
    (tmp_path / "short.tfrecord").write_bytes(bytes(data[:-3]))
    with pytest.raises(ValueError, match="truncated"):
        list(ingest_tf.read_tfrecords(tmp_path / "short.tfrecord"))
    data[20] ^= 0xFF  # a byte of the first record's data
    (tmp_path / "bad.tfrecord").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC32C"):
        ingest_tf.load_examples_tfrecord(tmp_path / "bad.tfrecord")


def _shared_features(x):
    x = np.asarray(x, np.float64)
    return np.stack([x[..., 0].mean(axis=(1, 2)), x[..., 1].mean(axis=(1, 2)),
                     x[..., 2].std(axis=(1, 2)), x[:, :8, :8].mean(axis=(1, 2, 3))], axis=1)


def _torch_features(x):
    return torch.from_numpy(_shared_features(x.numpy().transpose(0, 2, 3, 1)))


def _jax_features(x):
    return jnp.asarray(_shared_features(np.asarray(x)))


def test_google_fid_topk_matches_jax(saved_root, models, converted, tmp_path):
    rng = np.random.RandomState(2)
    n = 10
    latents = rng.randn(n, SPEC.dlatent_dim).astype(np.float32)
    originals = rng.rand(n, SPEC.image_size, SPEC.image_size, 3).astype(np.float32)
    picks = [(0, 5), (1, 40)]
    jmodels = jingest.GoogleStylExTF(saved_root, num_layers=SPEC.num_layers)
    jgen = jingest.convert_google_generator(saved_root / "generator.savedmodel")

    ours = ingest_tf.google_fid_topk(models, originals, latents, picks, k=2, batch_size=4,
                                     feature_fn=_torch_features, generator=converted,
                                     csv_path=str(tmp_path / "port" / "fid_results.csv"))
    theirs = jingest.google_fid_topk(jmodels, originals, latents, picks, k=2, batch_size=4,
                                     feature_fn=_jax_features, jax_generator=jgen)
    assert len(ours) == 3 and all(np.isfinite(ours))
    np.testing.assert_allclose(ours, theirs, rtol=1e-3)
    rows = list(csv.reader(open(tmp_path / "port" / "fid_results.csv")))
    assert [r[0] for r in rows] == ["k", "generated", "1", "2"]
    np.testing.assert_allclose([float(r[1]) for r in rows[1:]], ours, rtol=1e-12)

    # without a generator both packages take TF's mutation loop
    ours_tf = ingest_tf.google_fid_topk(models, originals, latents, picks, k=2, batch_size=4,
                                        feature_fn=_torch_features)
    theirs_tf = jingest.google_fid_topk(jmodels, originals, latents, picks, k=2, batch_size=4,
                                        feature_fn=_jax_features)
    np.testing.assert_allclose(ours_tf, theirs_tf, rtol=1e-3)
