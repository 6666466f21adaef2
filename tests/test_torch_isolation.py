"""The port stands alone: it imports neither JAX nor the JAX package, its
default-device entry points refuse to run without a GPU, and its kernel
wrappers take the plain versions on CPU tensors without touching the CUDA
build."""

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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'stylex_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(_module_names()) >= 15


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import\s+(jax|flax|stylex_tpu)\b|from\s+(jax|flax|stylex_tpu)[\s.])",
                         re.M)
    for path in PKG.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())


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
    trainer = Trainer(base_dir=str(tmp_path), model_cfg=TINY, classifier_name="mobilenet",
                      device="cpu")
    assert trainer.device == torch.device("cpu")


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
