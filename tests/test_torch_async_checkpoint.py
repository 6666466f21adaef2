"""The port's background checkpoint writer, on the CPU: what
``tests/test_async_checkpoint.py`` checks of the JAX package's.

The asynchronous write gives the same file as the blocking save, bit for
bit; the file holds the state at submit time whatever the caller does to
the live tensors afterwards; the writer's error surfaces on ``wait``, once;
no partial file is ever visible under the checkpoint's name; a trainer
that saves in the background and keeps stepping reloads the state of its
save. (On a GPU the snapshot's copies to the host are waited for through a
CUDA event before the writer reads them; ``chip_smoke.py`` phase 10 holds
that path.)
"""

import threading
import time
import types

import pytest
import torch

from stylex_tpu_torch.config import ModelConfig, TrainConfig
from stylex_tpu_torch.utils import checkpoint as ckpt
from stylex_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    load_checkpoint,
    save_checkpoint,
)

TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)


def _state(seed=0):
    """A stand-in train state: a model, two Adam optimizers with moments,
    the counters."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    g_opt = torch.optim.Adam(model[0].parameters(), lr=1e-3, betas=(0.5, 0.9))
    d_opt = torch.optim.Adam(model[1].parameters(), lr=1e-3, betas=(0.5, 0.9))
    model(torch.randn(5, 4)).square().sum().backward()
    g_opt.step()
    d_opt.step()
    return types.SimpleNamespace(model=model, g_opt=g_opt, d_opt=d_opt, step=7,
                                 pl_mean=torch.tensor(0.25), device=torch.device("cpu"))


def _assert_state_equal(a, b):
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for oa, ob in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        for sa, sb in zip(oa.state_dict()["state"].values(), ob.state_dict()["state"].values()):
            for k in sa:
                assert torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])), k
    assert a.step == b.step and torch.equal(a.pl_mean, b.pl_mean)


def test_async_write_matches_blocking(tmp_path):
    state = _state()
    sync_path = save_checkpoint(str(tmp_path / "sync"), "m", 3, state, extra={"version": "x"})
    w = AsyncCheckpointWriter()
    async_path = w.submit(str(tmp_path / "async"), "m", 3, state, extra={"version": "x"})
    w.wait()
    with open(sync_path, "rb") as f1, open(async_path, "rb") as f2:
        assert f1.read() == f2.read()
    restored = _state(seed=1)
    load_checkpoint(async_path, restored)
    _assert_state_equal(restored, state)
    assert torch.load(async_path, weights_only=True)["version"] == "x"


def test_snapshot_survives_source_mutation(tmp_path, monkeypatch):
    """The live tensors change in place right after submit, while the
    writer has not serialised yet: the file holds the state at submit."""
    real = ckpt._write_checkpoint_file
    started = threading.Event()

    def slow_write(path, payload):
        started.set()
        time.sleep(0.3)
        real(path, payload)

    monkeypatch.setattr(ckpt, "_write_checkpoint_file", slow_write)
    state = _state()
    want = _state()
    w = AsyncCheckpointWriter()
    path = w.submit(str(tmp_path), "m", 0, state)
    assert started.wait(5)
    with torch.no_grad():
        for p in state.model.parameters():
            p.fill_(-1.0)
        for opt in (state.g_opt, state.d_opt):
            for st in opt.state.values():
                st["exp_avg"].fill_(-2.0)
    state.pl_mean.fill_(9.0)
    w.wait()
    restored = _state(seed=1)
    load_checkpoint(path, restored)
    _assert_state_equal(restored, want)


def test_writer_error_surfaces_on_wait(tmp_path, monkeypatch):
    def boom(path, payload):
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt, "_write_checkpoint_file", boom)
    w = AsyncCheckpointWriter()
    w.submit(str(tmp_path), "m", 0, _state())
    with pytest.raises(OSError, match="disk gone"):
        w.wait()
    w.wait()  # the error is raised once; the writer is reusable
    assert w._thread is None


def test_no_partial_file_is_published(tmp_path, monkeypatch):
    """While the writer is inside ``torch.save``, the checkpoint's name does
    not exist; after it, only the finished file does."""
    release, inside = threading.Event(), threading.Event()
    real_save = torch.save

    def gated_save(obj, f, *a, **k):
        real_save(obj, f, *a, **k)
        inside.set()
        assert release.wait(5)

    monkeypatch.setattr(ckpt.torch, "save", gated_save)
    w = AsyncCheckpointWriter()
    path = w.submit(str(tmp_path), "m", 1, _state())
    assert inside.wait(5)
    names = sorted(p.name for p in (tmp_path / "m").iterdir())
    assert names == ["model_1.pt.tmp"]
    release.set()
    w.wait()
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == ["model_1.pt"]
    assert path.endswith("model_1.pt")


def test_trainer_async_save_roundtrip(tmp_path):
    """Saves at steps 0 and 2 go to the writer while training goes on; a
    fresh trainer's load(-1) reads the state of the second save."""
    from stylex_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(batch_size=2, gradient_accumulate_every=2, aug_prob=0.0, save_every=2,
                     evaluate_every=10**9, async_save=True)
    t = Trainer(name="as", base_dir=str(tmp_path), model_cfg=ModelConfig(**TINY), train_cfg=tc,
                classifier_name="mobilenet", device="cpu")
    try:
        t.set_data_src(dataset_name="synthetic")
        for i in range(4):
            t.train()
            if i == 2:  # the save of step 2 was submitted inside this call
                saved = {k: v.clone() for k, v in t.state.model.state_dict().items()}
                adam = t.state.d_opt.state_dict()["state"][0]["exp_avg"].clone()
        assert not torch.equal(t.state.model.D.fc.weight, saved["D.fc.weight"])
    finally:
        t.close()
    t2 = Trainer(name="as", base_dir=str(tmp_path), model_cfg=ModelConfig(**TINY), train_cfg=tc,
                 classifier_name="mobilenet", device="cpu")
    try:
        t2.load(-1)
        assert t2.steps == 3  # checkpoint 1, written after step 2 ran
        for k, v in t2.state.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        assert torch.equal(t2.state.d_opt.state_dict()["state"][0]["exp_avg"], adam)
    finally:
        t2.close()
