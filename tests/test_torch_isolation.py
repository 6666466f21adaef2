"""The port stands alone: it imports neither JAX, flax, msgpack, ml_dtypes
nor the JAX package (its codec of flax's msgpack format works with those
hidden), nor TensorFlow when a module is imported (``ingest_tf`` imports it
inside the functions that read a SavedModel), its default-device entry
points refuse to run without a GPU, and its kernel wrappers take the plain
versions on CPU tensors without touching the CUDA build."""

import ast
import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import stylex_tpu_torch
from stylex_tpu_torch import csrc
from stylex_tpu_torch.config import ModelConfig
from stylex_tpu_torch.ops import blur as tblur

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "stylex_tpu_torch"
TINY = ModelConfig(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)


def _module_names():
    return sorted(m.name for m in pkgutil.walk_packages(stylex_tpu_torch.__path__,
                                                         "stylex_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'stylex_tpu', 'msgpack', 'ml_dtypes', 'tensorflow'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    names = _module_names()
    assert len(names) >= 15
    for new in ("utils.flax_msgpack", "ingest", "run_counterfactual", "train_classifier",
                "train.classifier_training", "data.labeled", "data.download", "ingest_tf",
                "models.google_stylex", "native", "utils.profiling", "utils.timing",
                "utils.device", "utils.cache", "parallel.mesh", "parallel.launch",
                "testing.harness", "version"):
        assert f"stylex_tpu_torch.{new}" in names, new


def test_package_modules_load_without_the_test_scaffolding():
    """``stylex_tpu_torch.testing`` (the tests' rank functions, which patch
    ``torch.nn.functional`` and the environment while they run) is imported
    by no other module of the package."""
    names = [n for n in _module_names() if not n.startswith("stylex_tpu_torch.testing")]
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith('stylex_tpu_torch.testing'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "stylex_tpu_torch.cli" in names and "stylex_tpu_torch.parallel.launch" in names


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import\s+(jax|flax|stylex_tpu|msgpack|ml_dtypes)\b|"
                         r"from\s+(jax|flax|stylex_tpu|msgpack|ml_dtypes)[\s.])", re.M)
    for path in PKG.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())


def test_tensorflow_is_imported_only_inside_functions():
    """No module of the port imports TensorFlow at module level; the native
    loader builds the port's own copy of the C++ source."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "tensorflow" for n in names), path
    ingest_tf = (PKG / "ingest_tf.py").read_text()
    assert "import tensorflow as tf" in ingest_tf
    from stylex_tpu_torch import native

    assert native._SRC == PKG / "native" / "pixel_ops.cpp" and native._SRC.exists()
    assert "stylex_tpu.native" not in (PKG / "native" / "__init__.py").read_text()


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from stylex_tpu_torch.device import resolve_device
    from stylex_tpu_torch.models import build_classifier, build_stylex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_stylex(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_classifier("mobilenet", 16)
    from stylex_tpu_torch.models.google_stylex import GoogleStylExGenerator, GoogleStylExSpec
    from stylex_tpu_torch.utils.device import init_on_host

    spec = GoogleStylExSpec(image_size=8, dlatent_dim=4, channels_map=((4, 4), (8, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GoogleStylExGenerator(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_on_host(torch.zeros, 2)
    assert GoogleStylExGenerator(spec, device="cpu").const.device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from stylex_tpu_torch import cli
    from stylex_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(base_dir=str(tmp_path), model_cfg=TINY, classifier_name="mobilenet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dataset-name", "synthetic", "--image-size", "16",
                  "--results-dir", str(tmp_path / "r"), "--models-dir", str(tmp_path / "m")])
    # several ranks on the default device: refused before any rank starts
    from stylex_tpu_torch.parallel import launch
    from stylex_tpu_torch.testing import harness

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--dataset-name", "synthetic", "--image-size", "16", "--num-devices", "2",
                  "--results-dir", str(tmp_path / "r"), "--models-dir", str(tmp_path / "m")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(harness.run, 2, args=([],))
    trainer = Trainer(base_dir=str(tmp_path), model_cfg=TINY, classifier_name="mobilenet",
                      device="cpu")
    assert trainer.device == torch.device("cpu")


def test_flax_msgpack_codec_needs_no_msgpack(tmp_path):
    """With msgpack, flax, jax and ml_dtypes unimportable, the codec reads a
    file that flax wrote (bfloat16 leaf included) and writes one that flax
    reads back."""
    from flax import serialization

    import jax.numpy as jnp

    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": np.asarray(3, np.int32),
            "bf": jnp.asarray([1.5, -2.0], jnp.bfloat16), "masked": {}}
    (tmp_path / "in.msgpack").write_bytes(serialization.msgpack_serialize(tree))
    code = (
        "import sys\n"
        "for m in ('msgpack', 'flax', 'jax', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from stylex_tpu_torch.utils import flax_msgpack as fm\n"
        f"t = fm.load({str(tmp_path / 'in.msgpack')!r})\n"
        "assert t['w'].tolist() == [[0, 1, 2], [3, 4, 5]] and int(t['step']) == 3\n"
        "assert t['bf'].dtype == torch.bfloat16 and t['bf'].tolist() == [1.5, -2.0]\n"
        "assert t['masked'] == {}\n"
        "t['w'] = t['w'] * 2\n"
        f"fm.dump(t, {str(tmp_path / 'out.msgpack')!r})\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
    back = serialization.msgpack_restore((tmp_path / "out.msgpack").read_bytes())
    assert back["w"].tolist() == [[0, 2, 4], [6, 8, 10]] and back["step"] == 3
    assert str(back["bf"].dtype) == "bfloat16" and back["bf"].tolist() == [1.5, -2.0]
    assert back["masked"] == {}


def test_weight_and_classifier_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from stylex_tpu_torch import run_attfind, run_counterfactual, train_classifier
    from stylex_tpu_torch.attfind import AttFindRecords, save_records
    from stylex_tpu_torch.models.stylex import StylEx
    from stylex_tpu_torch.train.classifier_training import ClassifierTrainer
    from stylex_tpu_torch.train.state import create_train_state
    from stylex_tpu_torch.config import TrainConfig
    from stylex_tpu_torch.train.trainer import Trainer
    from stylex_tpu_torch.utils.checkpoint import load_checkpoint_inference, save_jax_checkpoint

    state = create_train_state(StylEx(TINY), TINY, TrainConfig())
    path = save_jax_checkpoint(str(tmp_path / "models"), "m", 1, state)
    (tmp_path / "models" / "m" / ".config.json").write_text(TINY.to_json())
    model_args = ["--name", "m", "--base-dir", str(tmp_path), "--classifier-name", "mobilenet"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint_inference(path, state)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClassifierTrainer("mobilenet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_classifier.main(["--dataset", "synthetic", "--image-size", "32", "--epochs", "1",
                               "--saved-models-dir", str(tmp_path / "s"),
                               "--results-dir", str(tmp_path / "r"),
                               "--tensorboard-dir", str(tmp_path / "tb")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_attfind.main([*model_args, "--dataset-name", "synthetic", "--num-images", "1",
                          "--results-folder", str(tmp_path / "a")])
    att = tmp_path / "att"
    att.mkdir()
    n, c, s = 1, 4, TINY.image_size
    save_records(AttFindRecords(
        np.zeros((n, 2, c, 2), np.float32), np.zeros((n, TINY.latent_dim), np.float32),
        np.zeros((n, 2), np.float32), np.zeros(c, np.float32), np.ones(c, np.float32),
        np.zeros((n, c), np.float32), np.zeros((n, s, s, 3), np.float32),
        np.zeros((1, s, s, 1), np.float32), np.zeros((n, 1), np.float32)),
        str(att / "style_change_records.npz"))
    (att / "top_styles.json").write_text('{"ranked": [[0, 1]]}')
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_counterfactual.main([*model_args, "--attfind-dir", str(att)])
    trainer = Trainer(name="m", base_dir=str(tmp_path), classifier_name="mobilenet",
                      device="cpu")
    trainer.load(1, inference=True)
    assert trainer.state.device == torch.device("cpu")
    trainer.close()


@pytest.mark.parametrize("name", ["upsample2x_bilinear", "blur3", "blur3_downsample2x"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_plain_path_on_cpu(monkeypatch, name, dtype):
    def no_build(*_):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")

    monkeypatch.setattr(csrc, "load", no_build)
    before = dict(tblur.LAUNCHES)
    shape = (2, 3, 6, 8) if name == "blur3_downsample2x" else (2, 3, 5, 6)
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32)).to(dtype)
    x.requires_grad_(True)
    got = getattr(tblur, name)(x)
    want = getattr(tblur, f"{name}_plain")(x)
    assert got.dtype == dtype and torch.equal(got, want)
    # backward and double backward stay on the plain path too
    (g,) = torch.autograd.grad(got.float().square().sum(), x, create_graph=True)
    torch.autograd.grad(g.float().square().sum(), x)
    assert tblur.LAUNCHES == before


def test_frozen_bn_refuses_what_the_kernel_does_not_take(monkeypatch):
    """The batch-norm kernel's wrapper raises, without building anything, on
    a CPU input (float32 or bfloat16, NCHW or channels-last) and on a 3-d
    one; the module sends no CPU tensor to it."""
    from stylex_tpu_torch.ops import frozen_bn as fbn

    monkeypatch.setattr(csrc, "load", lambda *_: pytest.fail("a refused call built the kernel"))
    y = torch.zeros(2, 3, 4, 4)
    p = torch.zeros(3)
    for bad in (y, y.bfloat16(), y.to(memory_format=torch.channels_last), y[0]):
        assert not fbn.takes_kernel(bad)
        with pytest.raises(TypeError, match="frozen_bn"):
            fbn.frozen_bn(bad, p, p, p)
    assert not fbn.takes_kernel(torch.empty(2, 3, 4, 4, device="meta"))


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tblur.upsample2x_bilinear(x)
    with pytest.raises(ValueError, match="unsupported device"):
        tblur.blur3(x)
    with pytest.raises(ValueError, match="unsupported device"):
        tblur.blur3_downsample2x(x)


def test_extraction_refuses_mismatched_dtype():
    from stylex_tpu_torch.attfind import attfind_extraction
    from stylex_tpu_torch.models import build_stylex

    model = build_stylex(TINY, device="cpu")
    images = np.zeros((1, 16, 16, 3), np.float32)
    noise = np.zeros((1, 16, 16, 1), np.float32)
    with pytest.raises(ValueError, match="compute dtype"):
        attfind_extraction(model, lambda x: x.mean(dim=(2, 3))[:, :2], images, noise,
                           compute_dtype="bfloat16", progress=False)


def test_kernel_library_path_tracks_the_source():
    for name, (source, _) in csrc.KERNELS.items():
        assert (PKG / "csrc" / source).exists()
        path = csrc.library_path(name)
        assert path.parent == ROOT / "build" / "stylex_tpu_torch"
        assert path.name.startswith(Path(source).stem + "-") and path.suffix == ".so"
    # one library per source: the blur and the blur with decimation share one
    assert csrc.library_path("blur3") == csrc.library_path("blur3_downsample2x")
    assert len({csrc.library_path(n) for n in csrc.KERNELS}) == len(
        {source for source, _ in csrc.KERNELS.values()})


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No GPU here: the script exits non-zero and prints no result line; a
    directory holding only the script fails the same way."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             env=env, cwd=str(cwd), timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
