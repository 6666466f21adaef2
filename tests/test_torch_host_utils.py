"""The port's host utilities, on the CPU.

* ``native``: the C++ pixel pipeline equals PIL's resize, crop and float
  conversion bit for bit (the cases of ``tests/test_native.py`` and random
  sizes up and down), is within the JAX package's 2.5/255 of the JAX
  package's own C++ pipeline, writes into a batch row, and
  ``load_and_transform`` takes it (its call count moves) with the same
  result as the PIL path; RGBA images stay on the PIL path. Skipped where
  ``g++`` is missing, as the JAX package's test is.
* ``utils.timing``: ``measure_op`` positive and stable, its roofline
  guard raising on an impossible claim; ``measure_chained`` positive.
* ``utils.profiling``: ``StepTimer``'s rates; ``trace`` writes a Chrome
  trace, or nothing without a directory; ``Trainer.train()`` returns the
  step timer's keys beside the losses, as the JAX trainer does.
* ``utils.device.init_on_host`` casts float32 leaves only.
* ``utils.cache.enable_persistent_cache``: the build directory scoped by
  backend and host signature (also without ``/proc/cpuinfo``), and the
  ``STYLEX_TPU_NO_CACHE`` opt-out, as ``tests/test_cache.py`` holds the
  JAX package's.
* ``ops.evaluate_in_chunks`` and ``ops.downsample_blur`` against the JAX
  package's (float32, 1e-6 x max|ref|: the same taps summed in the same
  order on both sides, up to XLA's fusion).
"""

import builtins
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from stylex_tpu import native as jnative
from stylex_tpu.ops import blur as jblur
from stylex_tpu.ops import latents as jlatents
from stylex_tpu_torch import csrc, native
from stylex_tpu_torch.config import ModelConfig, TrainConfig
from stylex_tpu_torch.ops import downsample_blur, evaluate_in_chunks
from stylex_tpu_torch.utils import cache
from stylex_tpu_torch.utils.device import init_on_host
from stylex_tpu_torch.utils.profiling import StepTimer, trace
from stylex_tpu_torch.utils.timing import measure_chained, measure_op

torch.set_num_threads(2)


@pytest.fixture
def built():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native pipeline cannot be built")
    assert native.available(), native.build_error
    return native


def _pil(arr, out_size, crop):
    img = Image.fromarray(arr).resize((out_size[1], out_size[0]), Image.BILINEAR)
    w, h = img.size
    left, top = (w - crop[1]) // 2, (h - crop[0]) // 2
    img = img.crop((left, top, left + crop[1], top + crop[0]))
    return np.asarray(img, np.float32) / 255.0


@pytest.mark.parametrize("in_shape,out_size,crop", [
    ((100, 80, 3), (64, 51), 48),  # downscale
    ((40, 60, 3), (96, 144), 96),  # upscale
    ((64, 64, 3), (64, 64), 64),  # identity
    ((700, 530, 3), (84, 64), 64),  # a large downscale
    ((5, 9, 1), (17, 30), 15),  # one channel
])
def test_native_equals_pil_and_the_jax_pipeline(built, in_shape, out_size, crop):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, size=in_shape, dtype=np.uint8)
    got = native.resize_crop_normalize(arr, out_size, (crop, crop))
    want = _pil(arr[..., 0] if in_shape[2] == 1 else arr, out_size, (crop, crop))
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    if in_shape[2] == 3:
        theirs = jnative.resize_crop_normalize(arr, out_size, (crop, crop))
        assert np.abs(got - theirs).max() <= 2.5 / 255.0


def test_native_equals_pil_at_random_sizes(built):
    rng = np.random.RandomState(1)
    for _ in range(200):
        h, w = rng.randint(1, 90, size=2)
        oh, ow = rng.randint(1, 110, size=2)
        crop = (rng.randint(1, oh + 1), rng.randint(1, ow + 1))
        arr = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(native.resize_crop_normalize(arr, (oh, ow), crop),
                                      _pil(arr, (oh, ow), crop))


def test_native_normalize_hflip_and_batch_row(built):
    rng = np.random.RandomState(2)
    arr = rng.randint(0, 256, size=(8, 8, 3), dtype=np.uint8)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    want = (arr[:, ::-1].astype(np.float32) / 255.0 - mean) / std
    np.testing.assert_array_equal(native.normalize_u8(arr, mean, std, hflip=True), want)
    got = native.resize_crop_normalize(arr, (8, 8), (8, 8), mean, std, hflip=True)
    np.testing.assert_array_equal(got, want)
    big = rng.randint(0, 256, size=(50, 70, 3), dtype=np.uint8)
    batch = np.zeros((4, 32, 32, 3), np.float32)
    out = native.resize_crop_normalize(big, (32, 44), (32, 32), out=batch[1])
    assert np.shares_memory(out, batch) and batch[1].max() > 0 and batch[0].max() == 0
    with pytest.raises(ValueError):
        native.resize_crop_normalize(big, (32, 44), (40, 32))  # crop beyond the resize
    with pytest.raises(ValueError):
        native.resize_crop_normalize(big, (32, 44), (32, 32), out=np.zeros((32, 32, 3)))


def test_load_and_transform_takes_the_native_path(built, tmp_path, monkeypatch):
    from stylex_tpu_torch.data.dataset import load_and_transform

    rng = np.random.RandomState(3)
    paths = []
    for i, (size, mode) in enumerate((((90, 70), "RGB"), ((12, 10), "RGB"), ((33, 47), "L"))):
        p = tmp_path / f"img{i}.png"
        shape = size[::-1] + ((3,) if mode == "RGB" else ())
        Image.fromarray(rng.randint(0, 256, size=shape).astype(np.uint8), mode).save(p)
        paths.append(p)
    before = native.CALLS["resize_crop_normalize"]
    got = [load_and_transform(p, 32) for p in paths]
    assert native.CALLS["resize_crop_normalize"] == before + 3
    row = np.zeros((2, 32, 32, 3), np.float32)
    assert np.shares_memory(load_and_transform(paths[0], 32, out=row[1]), row)
    np.testing.assert_array_equal(row[1], got[0])
    monkeypatch.setattr(native, "available", lambda: False)
    for p, g in zip(paths, got):
        want = load_and_transform(p, 32)
        assert g.shape == want.shape == (32, 32, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, want)
    monkeypatch.undo()
    rgba = tmp_path / "rgba.png"
    Image.fromarray(rng.randint(0, 256, size=(20, 30, 4)).astype(np.uint8), "RGBA").save(rgba)
    before = native.CALLS["resize_crop_normalize"]
    assert load_and_transform(rgba, 16, transparent=True).shape == (16, 16, 4)
    assert native.CALLS["resize_crop_normalize"] == before


def test_measure_op_positive_and_stable():
    from stylex_tpu_torch.ops import blur3

    x = torch.randn(4, 8, 16, 16, generator=torch.Generator().manual_seed(0))
    t = measure_op(blur3, [x], n_pair=(2, 8), repeats=2)
    assert t.seconds > 0 and t.spread >= 0 and t.eff_bandwidth is None
    assert torch.equal(x, torch.randn(4, 8, 16, 16, generator=torch.Generator().manual_seed(0)))
    t = measure_op(blur3, [x], repeats=2, target_seconds=0.02, bytes_moved=2 * x.numel() * 4)
    assert t.seconds > 0 and t.eff_bandwidth == pytest.approx(2 * x.numel() * 4 / t.seconds)


def test_measure_op_roofline_guard():
    x = torch.ones(2, 4, 4, 4)
    with pytest.raises(RuntimeError, match="roofline"):
        measure_op(lambda a: a + 1, [x], n_pair=(2, 8), repeats=2, bytes_moved=10**15)
    with pytest.raises(ValueError):
        measure_op(lambda a: a, [torch.ones(3, dtype=torch.int64)], n_pair=(2, 8))


def test_measure_chained_positive():
    t = measure_chained(lambda i, c: c * 0.5 + torch.tanh(c), torch.ones(64, 64),
                        n_pair=(2, 6), repeats=2)
    assert t.seconds > 0


def test_step_timer_stats():
    timer = StepTimer(window=2)
    assert timer.stats(images_per_step=8) == {"step_time_s": 0.0, "steps_per_sec": 0.0}
    timer.durations.extend([0.5, 0.25, 0.25])  # the window keeps the last two
    stats = timer.stats(images_per_step=8)
    assert stats == {"step_time_s": 0.25, "steps_per_sec": 4.0, "imgs_per_sec": 32.0}
    with timer:
        pass
    assert len(timer.durations) == 2 and timer.durations[-1] >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).add_(1)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1 and "traceEvents" in json.loads(files[0].read_text())


def test_trainer_train_returns_the_step_timer_keys(tmp_path):
    """The JAX trainer returns the losses and its StepTimer's
    ``step_time_s``, ``steps_per_sec`` and ``imgs_per_sec``; so does the
    port's."""
    from stylex_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(batch_size=2, gradient_accumulate_every=2, aug_prob=0.0, save_every=1000,
                     evaluate_every=1000, num_image_tiles=2)
    t = Trainer(name="t", base_dir=str(tmp_path), model_cfg=ModelConfig(
        image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32), train_cfg=tc,
        classifier_name="mobilenet", device="cpu")
    try:
        t.set_data_src(dataset_name="synthetic")
        metrics = t.train()
    finally:
        t.close()
    assert {"step_time_s", "steps_per_sec", "imgs_per_sec", "g_loss", "d_loss"} <= set(metrics)
    assert metrics["step_time_s"] > 0
    assert metrics["imgs_per_sec"] == pytest.approx(2 * 2 / metrics["step_time_s"])


def test_init_on_host_casts_float32_leaves():
    def build(n):
        m = torch.nn.Sequential(torch.nn.Linear(n, 3), torch.nn.BatchNorm1d(3))
        m[1].register_buffer("counts", torch.arange(3))
        return m

    m = init_on_host(build, 4, dtype=torch.bfloat16, device="cpu")
    assert m[0].weight.dtype == torch.bfloat16 and m[1].running_mean.dtype == torch.bfloat16
    assert m[1].counts.dtype == torch.int64 and m[1].num_batches_tracked.dtype == torch.int64
    tree = init_on_host(lambda: {"w": torch.ones(2), "i": torch.ones(2, dtype=torch.int32),
                                 "d": [torch.ones(1, dtype=torch.float64)]},
                        dtype=torch.float16, device="cpu")
    assert (tree["w"].dtype, tree["i"].dtype, tree["d"][0].dtype) == (
        torch.float16, torch.int32, torch.float64)
    assert init_on_host(lambda: torch.zeros(2), device="cpu").dtype == torch.float32


@pytest.fixture
def restore_build_dir():
    prior = csrc.BUILD_DIR
    yield
    csrc.BUILD_DIR = prior


def test_cache_dir_is_backend_and_host_scoped(tmp_path, restore_build_dir):
    assert cache.enable_persistent_cache(str(tmp_path))
    leaf = str(Path(csrc.BUILD_DIR))[len(str(tmp_path)):].lstrip("/")
    backend, _, sig = leaf.partition("-")
    assert backend == ("cuda" if torch.cuda.is_available() else "cpu")
    assert len(sig) == 8 and int(sig, 16) >= 0 and Path(csrc.BUILD_DIR).is_dir()
    assert native.library_path().parent == Path(csrc.BUILD_DIR)
    assert csrc.library_path("blur3").parent == Path(csrc.BUILD_DIR)


def test_cache_host_sig_without_cpuinfo(tmp_path, monkeypatch, restore_build_dir):
    real_open = builtins.open

    def deny_cpuinfo(path, *a, **k):
        if path == "/proc/cpuinfo":
            raise PermissionError(path)
        return real_open(path, *a, **k)

    monkeypatch.setattr(builtins, "open", deny_cpuinfo)
    assert cache.enable_persistent_cache(str(tmp_path))
    sig = Path(csrc.BUILD_DIR).name.partition("-")[2]
    assert sig != "unknown" and len(sig) == 8 and int(sig, 16) >= 0


def test_cache_opt_out(tmp_path, monkeypatch, restore_build_dir):
    monkeypatch.setenv("STYLEX_TPU_NO_CACHE", "1")
    prior = Path(csrc.BUILD_DIR)
    assert not cache.enable_persistent_cache(str(tmp_path))
    assert Path(csrc.BUILD_DIR) == prior


def test_evaluate_in_chunks_and_downsample_blur_match_jax():
    rng = np.random.RandomState(4)
    a = rng.randn(10, 3).astype(np.float32)
    b = rng.randn(10, 2).astype(np.float32)

    def fn(x, y):
        return x.sum(-1, keepdims=True) * y

    for chunk in (3, 10, 20):
        got = evaluate_in_chunks(chunk, fn, torch.from_numpy(a), torch.from_numpy(b))
        want = jlatents.evaluate_in_chunks(chunk, fn, jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    x = rng.randn(2, 8, 12, 3).astype(np.float32)  # NHWC for the JAX side
    want = np.asarray(jblur.downsample_blur(jnp.asarray(x)))
    got = downsample_blur(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
