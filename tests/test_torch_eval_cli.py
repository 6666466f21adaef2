"""The port's evaluation entry points on the CPU: ``Trainer.calculate_fid``
(against the JAX trainer's, and its real-stats cache), the FID cadence of
``train()``, interpolation GIFs, the CLI's evaluation flags, the replay
CLI (report-only against the JAX one), the user-study answer key (byte
for byte the JAX one's) and ``run_attfind --visualize-top``."""

import inspect
import json
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from stylex_tpu import cli as jcli
from stylex_tpu import replay_results as jreplay
from stylex_tpu import user_study as juser_study
from stylex_tpu.attfind.extraction import AttFindRecords as JRecords
from stylex_tpu.config import Arch as JArch
from stylex_tpu.config import ModelConfig as JModelConfig
from stylex_tpu.config import TrainConfig as JTrainConfig
from stylex_tpu.models import build_stylex as j_build_stylex, init_stylex_params
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu.ops.latents import image_noise as j_image_noise
from stylex_tpu.ops.latents import latent_noise as j_latent_noise
from stylex_tpu.train.trainer import Trainer as JTrainer
from stylex_tpu_torch import cli, replay_results, run_attfind, user_study
from stylex_tpu_torch.attfind import AttFindRecords, save_records_hdf5
from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig
from stylex_tpu_torch.models import build_classifier, build_stylex
from stylex_tpu_torch.models.convert import train_state_from_jax
from stylex_tpu_torch.train import trainer as trainer_mod
from stylex_tpu_torch.train.trainer import ModelLoader, Trainer

torch.set_num_threads(2)

TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)
EVAL_FLAGS = ("generate_interpolation", "interpolation_num_steps", "save_frames",
              "calculate_fid_every", "calculate_fid_num_images", "clear_fid_cache",
              "dataset_name")


def _shared_features(x):
    x = np.asarray(x, np.float64)
    return np.stack([x[..., 0].mean(axis=(1, 2)), x[..., 1].mean(axis=(1, 2)),
                     x[..., 2].std(axis=(1, 2)), x[:, :8, :8].mean(axis=(1, 2, 3))], axis=1)


def _torch_features(x):
    return torch.from_numpy(_shared_features(x.cpu().numpy().transpose(0, 2, 3, 1)))


def _real_batches(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(2, 16, 16, 3) * 255).astype(np.uint8) for _ in range(n)]


def _loader(batches):
    return types.SimpleNamespace(sample_loader=iter(batches))


def _tiny_trainer(tmp_path, name="t", arch="old", **tc):
    tc = TrainConfig(**{**dict(batch_size=2, gradient_accumulate_every=1, save_every=1000,
                               evaluate_every=1000, num_image_tiles=2, aug_prob=0.0), **tc})
    return Trainer(name=name, base_dir=str(tmp_path),
                   model_cfg=ModelConfig(**TINY, arch=Arch(arch)), train_cfg=tc,
                   classifier_name="mobilenet", device="cpu")


@pytest.mark.parametrize("arch", ["old", "new"])
def test_calculate_fid_matches_jax_trainer(tmp_path, monkeypatch, arch):
    """The same weights (the JAX train state carried across), the same
    injected real batches and fake draws, one shared feature function."""
    import stylex_tpu.eval.fid as jfid

    jtc = JTrainConfig(batch_size=2, gradient_accumulate_every=1, num_devices=1)
    jt = JTrainer(name="j", base_dir=str(tmp_path / "j"),
                  model_cfg=JModelConfig(**TINY, arch=JArch(arch)), train_cfg=jtc,
                  classifier_name="mobilenet")
    jt.init_stylex()
    jt.loader = _loader(_real_batches(4))

    def shared(x):
        return jax.numpy.asarray(_shared_features(np.asarray(x)))

    shared.tag = "shared"
    monkeypatch.setattr(jfid, "resolve_feature_fn", lambda fn=None: shared)
    want = jt.calculate_fid(4, eval_batch_images=4)

    t = _tiny_trainer(tmp_path / "p", arch=arch)
    t.state = train_state_from_jax(jax.tree.map(np.asarray, jt.state), t.model_cfg,
                                   t.train_cfg, device="cpu")
    t.loader = _loader(_real_batches(4))
    _torch_features.tag = "shared"
    monkeypatch.setattr(trainer_mod, "resolve_feature_fn", lambda device=None: _torch_features)

    def jax_draws(i, b):
        kz, kn = jax.random.split(jax.random.PRNGKey(i))
        return (torch.from_numpy(np.array(j_latent_noise(kz, b, t.model_cfg.mapping_dim))),
                torch.from_numpy(np.array(j_image_noise(kn, b, 16))))

    monkeypatch.setattr(t, "fid_draws", jax_draws)
    got = t.calculate_fid(4, eval_batch_images=4)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_calculate_fid_caches_real_stats(tmp_path, monkeypatch):
    t = _tiny_trainer(tmp_path)
    t.init_stylex()
    calls = []

    def feats(x):
        calls.append(x.shape[0])
        return _torch_features(x)

    feats.tag = "a"
    monkeypatch.setattr(trainer_mod, "resolve_feature_fn", lambda device=None: feats)
    t.loader = _loader(_real_batches(3))
    first = t.calculate_fid(3)  # 6 images: one real batch of 6, one fake batch of 6
    cache = np.load(tmp_path / "fid" / "t" / "real_stats.npz")
    assert str(cache["extractor"]) == "a" and int(cache["num_batches"]) == 3
    assert calls == [6, 6]

    t.loader = _loader([])  # a cache hit reads no real image
    assert t.calculate_fid(3) == first and calls == [6, 6, 6]
    with pytest.raises(RuntimeError, match="StopIteration"):  # another sample size: another key
        t.calculate_fid(2)
    t.loader = _loader(_real_batches(2, seed=1))
    t.calculate_fid(2)
    assert int(np.load(tmp_path / "fid" / "t" / "real_stats.npz")["num_batches"]) == 2

    feats.tag = "b"  # another extractor is another key
    t.loader = _loader(_real_batches(2, seed=1))
    t.calculate_fid(2)
    assert str(np.load(tmp_path / "fid" / "t" / "real_stats.npz")["extractor"]) == "b"

    t.clear_fid_cache = True  # recomputed once, then read again
    t.loader = _loader(_real_batches(2, seed=2))
    cleared = t.calculate_fid(2)
    assert t.clear_fid_cache is False
    t.loader = _loader([])
    assert t.calculate_fid(2) == cleared


def test_train_writes_fid_scores(tmp_path, monkeypatch):
    t = _tiny_trainer(tmp_path, calculate_fid_every=2, calculate_fid_num_images=6)
    _torch_features.tag = "shared"
    monkeypatch.setattr(trainer_mod, "resolve_feature_fn", lambda device=None: _torch_features)
    try:
        t.set_data_src(dataset_name="synthetic")
        for _ in range(3):  # steps 0, 1, 2: FID after step 2 only (never at step 0)
            t.train()
    finally:
        t.close()
    lines = (tmp_path / "results" / "t" / "fid_scores.txt").read_text().splitlines()
    assert len(lines) == 1
    step, value = lines[0].split(",")
    assert step == "2" and np.isfinite(float(value)) and float(value) == t.last_fid


@pytest.mark.parametrize("arch", ["old", "new"])
def test_interpolation_gif(tmp_path, arch):
    t = _tiny_trainer(tmp_path, arch=arch)
    path = t.generate_interpolation(num=3, num_steps=5, num_rows=2, save_frames=True)
    gif = Image.open(path)
    assert path.endswith("3.gif") and gif.n_frames == 5
    assert gif.info["duration"] == 80 and gif.info["loop"] == 0
    assert gif.size == (2 * 16 + 3 * 2,) * 2
    assert sorted(p.name for p in (tmp_path / "results" / "t" / "3").iterdir()) == [
        f"{i}.png" for i in range(5)]


def test_model_loader(tmp_path):
    t = _tiny_trainer(tmp_path, name="ml")
    t.init_stylex()
    t.save(0)
    loader = ModelLoader(base_dir=str(tmp_path), name="ml", classifier_name="mobilenet",
                         device="cpu")
    z = torch.randn(3, loader.trainer.model_cfg.mapping_dim,
                    generator=torch.Generator().manual_seed(0))
    w = loader.noise_to_styles(z, trunc_psi=0.5)
    imgs = loader.styles_to_images(w)
    assert imgs.shape == (3, 16, 16, 3) and 0.0 <= imgs.min() and imgs.max() <= 1.0
    w_full = loader.noise_to_styles(z)
    center = loader.trainer.style_mean()
    torch.testing.assert_close(w, 0.5 * (w_full - center) + center)


def test_cli_takes_the_evaluation_flags_with_jax_defaults(tmp_path):
    ours = inspect.signature(cli.train_from_folder).parameters
    theirs = inspect.signature(jcli.train_from_folder).parameters
    for flag in EVAL_FLAGS:
        assert ours[flag].default == theirs[flag].default, flag
    kwargs = cli.parse_argv(["--calculate-fid-every", "100", "--calculate-fid-num-images", "64",
                             "--clear-fid-cache", "--generate-interpolation",
                             "--interpolation-num-steps", "3", "--save-frames",
                             "--dataset-name", "MNIST"])
    assert kwargs == dict(calculate_fid_every=100, calculate_fid_num_images=64,
                          clear_fid_cache=True, generate_interpolation=True,
                          interpolation_num_steps=3, save_frames=True, dataset_name="MNIST")
    cli.main(["--generate-interpolation", "--interpolation-num-steps", "3", "--device", "cpu",
              "--image-size", "16", "--network-capacity", "4", "--num-image-tiles", "2",
              "--classifier-name", "mobilenet", "--name", "g",
              "--results-dir", str(tmp_path / "r"), "--models-dir", str(tmp_path / "m")])
    assert Image.open(tmp_path / "r" / "g" / "0.gif").n_frames == 3


def _records(C: int, latent_dim: int, n: int = 6, seed: int = 0):
    rng = np.random.RandomState(seed)
    coords = rng.randn(n, C).astype(np.float32)
    style_change = rng.uniform(0.0, 0.05, (n, 2, C, 2)).astype(np.float32)
    style_change[:, 0, 1, 0] = 0.9
    style_change[:, 1, 3, 0] = 0.8
    style_change[:, 0, 7, 1] = 0.7
    base_prob = np.tile([2.0, -2.0], (n, 1)).astype(np.float32)
    base_prob[n // 2:] *= -1
    return dict(style_change=style_change, latents=rng.randn(n, latent_dim).astype(np.float32),
                base_prob=base_prob, minima=coords.min(0) - 0.5, maxima=coords.max(0) + 0.5,
                style_coordinates=coords, original_images=rng.rand(n, 16, 16, 3).astype(np.float32),
                noise=rng.rand(1, 16, 16, 1).astype(np.float32),
                discriminator=np.zeros((n, 1), np.float32))


def test_replay_report_matches_jax(tmp_path, capsys):
    C = build_stylex(ModelConfig(**TINY), device="cpu").total_style_coords
    path = tmp_path / "style_change_records.hdf5"
    save_records_hdf5(AttFindRecords(**_records(C, 34)), str(path))
    argv = ["--records", str(path), "--num-indices", "3", "--effect-threshold", "0.1"]
    jreplay.main(argv + ["--out", str(tmp_path / "jax")])
    want_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
    replay_results.main(argv + ["--out", str(tmp_path / "port")])
    got_out = capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT")
    assert got_out == want_out
    got = json.loads((tmp_path / "port" / "top_styles.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "top_styles.json").read_text())
    assert got["ranked"]


@pytest.mark.parametrize("route", ["trainer", "reference"])
def test_replay_renders_panels_from_a_checkpoint(tmp_path, route):
    t = _tiny_trainer(tmp_path, name="rp")
    t.init_stylex()
    C = t.state.model.total_style_coords
    path = tmp_path / "records.hdf5"
    save_records_hdf5(AttFindRecords(**_records(C, 34)), str(path))
    if route == "trainer":
        t.save(0)
        model_args = ["--name", "rp", "--base-dir", str(tmp_path)]
    else:
        torch.save({"StylEx": t.state.model.state_dict()}, tmp_path / "model.pt")
        (tmp_path / "config.json").write_text(t.model_cfg.to_json())
        model_args = ["--checkpoint", str(tmp_path / "model.pt"),
                      "--config", str(tmp_path / "config.json")]
    out = tmp_path / "out"
    replay_results.main(["--records", str(path), "--out", str(out), "--num-indices", "2",
                         "--visualize-top", "2", "--max-images", "3", "--effect-threshold", "0.1",
                         "--classifier-name", "mobilenet", "--device", "cpu", *model_args])
    top = json.loads((out / "top_styles.json").read_text())["ranked"][:2]
    for d, s in top:
        panel = np.asarray(Image.open(out / f"style_{d}_{s}_by_distance.png"))
        assert panel.shape == (3 * (16 + 12), 32, 3)


def test_user_study_answer_key_matches_jax(tmp_path):
    jcfg = JModelConfig(**TINY)
    modules = j_build_stylex(jcfg)
    params = init_stylex_params(jax.random.PRNGKey(0), modules)
    clf_j = j_build_classifier("mobilenet", 16)
    model = build_stylex(ModelConfig(**TINY), device="cpu")
    clf = build_classifier("mobilenet", 16, device="cpu")
    fields = _records(model.total_style_coords, 34, n=7, seed=5)
    kw = dict(num_studies=5, num_indices=3, panel_px=24, frame_ms=500, seed=11)
    want = juser_study.generate_user_study(modules, params, clf_j.classify_images,
                                           JRecords(**fields), tmp_path / "jax", **kw)
    got = user_study.generate_user_study(model, clf.classify_images, AttFindRecords(**fields),
                                         tmp_path / "port", **kw)
    assert got == want
    key = (tmp_path / "port" / "info_of_images.txt").read_bytes()
    assert key == (tmp_path / "jax" / "info_of_images.txt").read_bytes()
    names = sorted(p.name for p in (tmp_path / "port").glob("*.gif"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.gif"))
    gif = Image.open(tmp_path / "port" / names[0])
    assert gif.n_frames == 2 and gif.size == (2 * 24 + 3 * 2,) * 2
    assert gif.info["duration"] == 500


def test_user_study_cli(tmp_path):
    model = build_stylex(ModelConfig(**TINY), seed=1, device="cpu")
    torch.save({"StylEx": model.state_dict()}, tmp_path / "model.pt")
    (tmp_path / "config.json").write_text(ModelConfig(**TINY).to_json())
    path = tmp_path / "records.hdf5"
    save_records_hdf5(AttFindRecords(**_records(model.total_style_coords, 34)), str(path))
    user_study.main(["--records", str(path), "--out", str(tmp_path / "us"), "--num-studies", "2",
                     "--panel-px", "20", "--checkpoint", str(tmp_path / "model.pt"),
                     "--config", str(tmp_path / "config.json"), "--classifier-name", "mobilenet",
                     "--device", "cpu"])
    assert len(list((tmp_path / "us").glob("class_study_*.gif"))) == 2
    assert (tmp_path / "us" / "info_of_images.txt").read_text().startswith("Odd transformation")
    with pytest.raises(SystemExit):
        user_study.main(["--records", str(path)])


def test_run_attfind_visualize_top(tmp_path):
    """The panels of the top styles that pass are saved beside the records:
    exactly those for which ``visualize_style`` (threshold 0.1, one image
    at least) gives a panel."""
    from stylex_tpu_torch.attfind import load_records_hdf5, visualize_style

    cfg = ModelConfig(**TINY)
    model = build_stylex(cfg, seed=2, device="cpu")
    torch.save({"StylEx": model.state_dict()}, tmp_path / "model.pt")
    (tmp_path / "config.json").write_text(cfg.to_json())
    clf = build_classifier("mobilenet", 16, seed=2, device="cpu")
    with torch.no_grad():
        clf.net.classifier[1].weight.mul_(100.0)  # probabilities that move with the shifts
    torch.save(clf.net.state_dict(), tmp_path / "clf.pt")
    out = tmp_path / "results"
    run_attfind.main(["--checkpoint", str(tmp_path / "model.pt"), "--config",
                      str(tmp_path / "config.json"), "--classifier-name", "mobilenet",
                      "--classifier-path", str(tmp_path / "clf.pt"), "--dataset-name",
                      "synthetic", "--num-images", "3", "--coord-batch", "64",
                      "--effect-threshold", "0.0", "--num-indices", "3", "--visualize-top", "3",
                      "--device", "cpu", "--results-folder", str(out)])
    records = load_records_hdf5(str(out / "style_change_records.hdf5"))
    ranked = json.loads((out / "top_styles.json").read_text())["ranked"][:3]
    expect = {f"style_{d}_{s}.png" for d, s in ranked
              if visualize_style(model, clf.classify_images, records, s, d, effect_threshold=0.1,
                                 min_images=1) is not None}
    assert expect
    assert {p.name for p in out.glob("style_*.png")} == expect


def test_records_without_h5py_go_to_npz(tmp_path, monkeypatch, capsys):
    """Where h5py is not installed the records go to a .npz of the same
    datasets, which the CLIs read as they read the hdf5."""
    from stylex_tpu_torch.attfind import load_records, records_file_name, save_records

    rec = AttFindRecords(**_records(build_stylex(ModelConfig(**TINY), device="cpu")
                                    .total_style_coords, 34))
    assert records_file_name() == "style_change_records.hdf5"
    a = load_records(save_records(rec, str(tmp_path / "r.hdf5")))
    b = load_records(save_records(rec, str(tmp_path / "r.npz")))
    for field in ("style_change", "latents", "base_prob", "minima", "maxima",
                  "style_coordinates", "original_images", "noise", "discriminator"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        np.testing.assert_array_equal(getattr(b, field), getattr(rec, field), err_msg=field)

    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    assert records_file_name() == "style_change_records.npz"
    cfg = ModelConfig(**TINY)
    torch.save({"StylEx": build_stylex(cfg, seed=3, device="cpu").state_dict()},
               tmp_path / "model.pt")
    (tmp_path / "config.json").write_text(cfg.to_json())
    out = tmp_path / "results"
    run_attfind.main(["--checkpoint", str(tmp_path / "model.pt"), "--config",
                      str(tmp_path / "config.json"), "--classifier-name", "mobilenet",
                      "--dataset-name", "synthetic", "--num-images", "2", "--coord-batch", "64",
                      "--device", "cpu", "--results-folder", str(out)])
    assert "h5py is not installed" in capsys.readouterr().out
    assert not (out / "style_change_records.hdf5").exists()
    replay_results.main(["--records", str(out / "style_change_records.npz"),
                         "--out", str(tmp_path / "replay")])
    assert json.loads((tmp_path / "replay" / "top_styles.json").read_text())["num_images"] == 2
