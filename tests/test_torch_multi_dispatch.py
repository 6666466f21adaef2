"""The host loop's dispatch knobs, on the CPU: blocks of steps, lagged
metrics, chunked sweeps.

* ``steps_per_dispatch=3`` trains 4 steps as blocks [1, 3] (step 0 is a
  boundary) and ends with the same parameters, optimizer moments and
  logged metrics as one step at a time, bit for bit: the block draws the
  same batches and randomness in the same order.
* Blocks end at every save / evaluate / FID step, which the port decides
  as the JAX trainer does (``_is_boundary`` equal over 3000 steps), and
  every step is logged.
* ``metrics_lag=0`` reads every step at once. With the lag on, a queued
  block is read once its copy has landed (at once on the CPU); with the
  copies held back, the queue holds ``metrics_lag // k`` blocks, and a NaN
  injected mid-block is caught ``max(metrics_lag, k) + k - 1`` steps late at
  most, reloads the latest checkpoint and raises ``NanException``.
* ``TrainConfig.from_json`` reads the JAX package's config with the knobs,
  whose defaults are the JAX package's.
* The CLI takes ``--steps-per-dispatch`` and ``--async-save`` and refuses
  the multi-device flags, naming ROADMAP's parallelism item.
* ``chunks_per_dispatch`` 3 and 8 give the records of 1, bit for bit, flat
  and block-resume, in process and through ``run_attfind``.
"""

import csv

import numpy as np
import pytest
import torch

from stylex_tpu.config import TrainConfig as JTrainConfig
from stylex_tpu_torch.config import ModelConfig, TrainConfig
from stylex_tpu_torch.train import trainer as trainer_mod
from stylex_tpu_torch.train.trainer import NanException, Trainer

torch.set_num_threads(2)

TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)


def _trainer(tmp_path, name, steps_per_dispatch=1, save_every=10**6, **tc):
    cfg = TrainConfig(batch_size=2, gradient_accumulate_every=2, aug_prob=0.0,
                      save_every=save_every, evaluate_every=10**9,
                      steps_per_dispatch=steps_per_dispatch, **tc)
    t = Trainer(name=name, base_dir=str(tmp_path), model_cfg=ModelConfig(**TINY),
                train_cfg=cfg, classifier_name="mobilenet", device="cpu")
    t.set_data_src(dataset_name="synthetic")
    return t


def _run(t, until):
    sizes = []
    while t.steps < until:
        before = t.steps
        t.train()
        sizes.append(t.steps - before)
    return sizes


def _csv_rows(tmp_path, name):
    with open(tmp_path / "results" / name / "metrics.csv") as f:
        return list(csv.DictReader(f))


def test_blocks_match_one_step_at_a_time_bit_for_bit(tmp_path):
    a = _trainer(tmp_path, "seq", 1)
    b = _trainer(tmp_path, "block", 3)
    try:
        assert _run(a, 4) == [1, 1, 1, 1]
        assert _run(b, 4) == [1, 3]
        a.flush()
        b.flush()
        for (k, x), y in zip(a.state.model.state_dict().items(),
                             b.state.model.state_dict().values()):
            assert torch.equal(x, y), k
        for oa, ob in ((a.state.g_opt, b.state.g_opt), (a.state.d_opt, b.state.d_opt)):
            for sa, sb in zip(oa.state.values(), ob.state.values()):
                assert torch.equal(sa["exp_avg"], sb["exp_avg"])
                assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        assert torch.equal(a.state.pl_mean, b.state.pl_mean)
        assert _csv_rows(tmp_path, "seq") == _csv_rows(tmp_path, "block")
    finally:
        a.close()
        b.close()


def test_train_returns_step_timer_stats(tmp_path):
    t = _trainer(tmp_path, "timer", 2)
    try:
        first = t.train()
        second = t.train()
    finally:
        t.close()
    for m in (first, second):
        assert {"d_loss", "g_loss", "step_time_s", "steps_per_sec", "imgs_per_sec"} <= set(m)
        assert m["step_time_s"] > 0
        assert m["steps_per_sec"] == pytest.approx(1.0 / m["step_time_s"])
    # one block of 1 step, then one of 2: the images per step of each block
    durations = list(t.step_timer.durations)
    assert len(durations) == 2
    assert second["imgs_per_sec"] == pytest.approx(2 * 2 * 2 / np.mean(durations))


def test_train_config_reads_the_jax_config_json():
    jtc = JTrainConfig(metrics_lag=3, steps_per_dispatch=5, async_save=False, num_devices=2,
                       num_train_steps=77, aug_types=("color",), calculate_fid_every=9)
    tc = TrainConfig.from_json(jtc.to_json())
    assert (tc.metrics_lag, tc.steps_per_dispatch, tc.async_save, tc.num_train_steps,
            tc.aug_types, tc.calculate_fid_every, tc.num_devices) == (3, 5, False, 77,
                                                                      ("color",), 9, 2)
    assert TrainConfig.from_json(tc.to_json()) == tc
    defaults = TrainConfig()
    assert (defaults.metrics_lag, defaults.steps_per_dispatch, defaults.async_save) == (
        JTrainConfig().metrics_lag, JTrainConfig().steps_per_dispatch, JTrainConfig().async_save)


@pytest.mark.parametrize("kw", [dict(), dict(evaluate_every=3), dict(save_every=7),
                                dict(calculate_fid_every=5, evaluate_every=250)])
def test_boundaries_match_the_jax_trainer(tmp_path, kw):
    from stylex_tpu.train.trainer import Trainer as JTrainer

    jt = JTrainer.__new__(JTrainer)  # _is_boundary reads train_cfg only
    jt.train_cfg = JTrainConfig(**kw)
    t = Trainer.__new__(Trainer)
    t.train_cfg = TrainConfig(**kw)
    assert [t._is_boundary(s) for s in range(3000)] == [jt._is_boundary(s)
                                                       for s in range(3000)]


def test_blocks_clamp_to_boundaries_and_log_every_step(tmp_path):
    t = _trainer(tmp_path, "bounded", 8, save_every=4, num_train_steps=11)
    try:
        seen = []
        while t.steps < 11:
            before = t.steps
            t.train()
            seen.append((before, t.steps))
        # step 0 is a save boundary (k = 1); 1..4 ends at save step 4; 5..8
        # at 8; then the block stops at num_train_steps
        assert seen == [(0, 1), (1, 5), (5, 9), (9, 11)]
        t.flush()
        names = sorted(p.name for p in (tmp_path / "models" / "bounded").iterdir())
        assert names == [".config.json", "model_0.pt", "model_1.pt", "model_2.pt"]
    finally:
        t.close()
    rows = _csv_rows(tmp_path, "bounded")
    assert [int(r["step"]) for r in rows] == list(range(11))
    assert all(np.isfinite(float(r["g_loss"])) for r in rows)


def test_evaluate_and_fid_steps_end_blocks(tmp_path, monkeypatch):
    fids = []
    monkeypatch.setattr(Trainer, "calculate_fid", lambda self, n: fids.append(self.steps) or 1.0)
    evals = []
    monkeypatch.setattr(Trainer, "evaluate", lambda self, **kw: evals.append(self.steps))
    t = _trainer(tmp_path, "cadence", 4, calculate_fid_every=3)
    t.train_cfg.evaluate_every = 5
    try:
        assert _run(t, 11) == [1, 3, 2, 1, 3, 1]
    finally:
        t.close()
    assert fids == [4, 7, 10]  # after steps 3, 6, 9 (never step 0)
    assert evals == [1, 6, 11]  # after steps 0, 5, 10


def test_metrics_lag_zero_is_synchronous(tmp_path, monkeypatch):
    t = _trainer(tmp_path, "sync", 1, metrics_lag=0)
    p = _trainer(tmp_path, "pipelined", 2, metrics_lag=8)
    try:
        monkeypatch.setattr(trainer_mod._Pending, "ready", lambda self: False)
        for _ in range(3):
            m = t.train()
            assert len(t._pending) == 0 and np.isfinite(m["g_loss"])
        # the copies held back: the first call reads all, then 8 // 2 blocks
        # stay queued
        queued = []
        for _ in range(7):
            p.train()
            queued.append(len(p._pending))
        assert queued == [0, 1, 2, 3, 4, 4, 4]
        p.flush()
        assert len(p._pending) == 0
        assert [int(r["step"]) for r in _csv_rows(tmp_path, "pipelined")] == list(range(13))
    finally:
        t.close()
        p.close()


def _inject_nan_at(t, nan_step):
    step_fn = t._step_fn

    def step(state, batch, draws):
        if state.step == nan_step:
            with torch.no_grad():
                state.model.D.fc.bias.fill_(float("nan"))
        return step_fn(state, batch, draws)

    t._step_fn = step


@pytest.mark.parametrize("held", [False, True])
def test_nan_mid_block_reloads_and_raises(tmp_path, monkeypatch, held):
    lag, k, nan_step = 8, 4, 2
    t = _trainer(tmp_path, f"nan{held}", k, metrics_lag=lag)
    if held:
        monkeypatch.setattr(trainer_mod._Pending, "ready", lambda self: False)
    try:
        t.train()  # step 0: saves checkpoint 0 (state at step 1)
        saved = t.state.model.G.initial_conv.weight.detach().clone()
        _inject_nan_at(t, nan_step)
        ran = 0
        with pytest.raises(NanException):
            while True:
                ran = t.steps
                t.train()
        last_run = ran + k - 1  # the block in which the NaN was read
        assert last_run - nan_step <= max(lag, k) + k - 1
        if not held:  # read at once: raised in the block of the NaN
            assert ran == 1
        assert t.steps == 1 and len(t._pending) == 0
        assert torch.equal(t.state.model.G.initial_conv.weight, saved)
        assert torch.isfinite(t.state.model.D.fc.bias).all()
    finally:
        t.close()
    # the steps before the NaN were logged; none at or after it
    assert [int(r["step"]) for r in _csv_rows(tmp_path, f"nan{held}")] == [0, 1]


def test_cli_takes_dispatch_flags_and_refuses_multi_device(tmp_path):
    from stylex_tpu_torch import cli

    args = ["--dataset-name", "synthetic", "--device", "cpu", "--image-size", "16",
            "--network-capacity", "4", "--batch-size", "2", "--gradient-accumulate-every", "2",
            "--classifier-name", "mobilenet", "--results-dir", str(tmp_path / "results"),
            "--models-dir", str(tmp_path / "models"), "--tensorboard-dir", "None",
            "--evaluate-every", "1000", "--num-image-tiles", "2"]
    cli.main(args + ["--num-train-steps", "5", "--steps-per-dispatch", "3",
                     "--async-save", "False"])
    rows = _csv_rows(tmp_path, "default")
    assert [int(r["step"]) for r in rows] == list(range(5))
    assert (tmp_path / "models" / "default" / "model_0.pt").exists()
    kwargs = cli.parse_argv(["--steps-per-dispatch", "4", "--async-save"])
    assert kwargs == {"steps_per_dispatch": 4, "async_save": True}
    # the multi-device flags are taken since data parallelism is ported
    assert cli.parse_argv(["--num-devices", "2", "--multi-gpus"]) == {"num_devices": 2,
                                                                       "multi_gpus": True}


@pytest.fixture(scope="module")
def sweep_model():
    from stylex_tpu_torch.data import SyntheticImageDataset
    from stylex_tpu_torch.models import build_classifier, build_stylex
    from stylex_tpu_torch.ops.latents import image_noise

    cfg = ModelConfig(**TINY)
    model = build_stylex(cfg, seed=0, device="cpu").eval()
    clf = build_classifier("mobilenet", 16, seed=0, device="cpu")
    images = np.stack([SyntheticImageDataset(2, 16)[i] for i in range(2)])
    noise = image_noise(torch.Generator().manual_seed(42), 1, 16).numpy()
    return model, clf, images, noise


FIELDS = ("style_change", "latents", "base_prob", "minima", "maxima", "style_coordinates",
          "original_images", "noise", "discriminator")


@pytest.mark.parametrize("block_resume", [True, False])
def test_chunked_sweep_records_equal_one_chunk(sweep_model, block_resume):
    from stylex_tpu_torch.attfind import attfind_extraction

    model, clf, images, noise = sweep_model
    runs = {K: attfind_extraction(model, clf.classify_images, images, noise, coord_batch=16,
                                  block_resume=block_resume, progress=False,
                                  chunks_per_dispatch=K)
            for K in (1, 3, 8)}
    for K in (3, 8):
        for f in FIELDS:
            assert np.array_equal(getattr(runs[K], f), getattr(runs[1], f)), (K, f)
    assert runs[1].style_change.shape == (2, 2, 136, 2)


def test_run_attfind_chunks_per_dispatch_flag(tmp_path):
    from stylex_tpu_torch import run_attfind
    from stylex_tpu_torch.attfind import load_records, records_file_name

    t = Trainer(name="m", base_dir=str(tmp_path), model_cfg=ModelConfig(**TINY),
                train_cfg=TrainConfig(), classifier_name="mobilenet", device="cpu")
    t.init_stylex()
    t.save(1)
    t.close()
    got = {}
    for K in ("1", "8"):
        out = tmp_path / f"out{K}"
        run_attfind.main(["--name", "m", "--base-dir", str(tmp_path), "--classifier-name",
                          "mobilenet", "--dataset-name", "synthetic", "--num-images", "2",
                          "--coord-batch", "24", "--chunks-per-dispatch", K, "--device", "cpu",
                          "--results-folder", str(out)])
        got[K] = load_records(str(out / records_file_name()))
    for f in FIELDS:
        assert np.array_equal(getattr(got["8"], f), getattr(got["1"], f)), f
