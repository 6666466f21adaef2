"""The port's configuration, data, StyleSpace helpers, checkpoint reader and
AttFind CLI, on the CPU: each against the JAX package's counterpart where
there is one (exact equality: both sides run the same numpy / PIL code or
integer arithmetic), and the CLI end to end at the tiny config."""

import json

import numpy as np
import pytest
import torch

from stylex_tpu.attfind import load_records_hdf5 as j_load_records
from stylex_tpu.config import Arch as JArch, ModelConfig as JModelConfig
from stylex_tpu.data import dataset as j_dataset
from stylex_tpu.data.mnist import SyntheticImageDataset as JSynthetic
from stylex_tpu.models import discriminator as j_disc
from stylex_tpu.models import generator as j_gen
from stylex_tpu_torch import run_attfind
from stylex_tpu_torch.config import Arch, ModelConfig
from stylex_tpu_torch.data import FolderDataset, SyntheticImageDataset
from stylex_tpu_torch.models import build_classifier, build_stylex, discriminator_filters
from stylex_tpu_torch.models import generator as t_gen
from stylex_tpu_torch.models.convert import load_reference_checkpoint
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.parallel import launch

torch.set_num_threads(2)

TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)


@pytest.mark.parametrize("arch", ["old", "new"])
def test_config_json_round_trips_with_jax(arch):
    cfg = ModelConfig(arch=Arch(arch), attn_layers=(1,), fq_layers=(2, 3), **TINY)
    jcfg = JModelConfig.from_json(cfg.to_json())
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())
    assert jcfg.arch == JArch(arch) and jcfg.mapping_dim == cfg.mapping_dim
    assert ModelConfig.from_json(JModelConfig(**TINY).to_json()) == ModelConfig(**TINY)


@pytest.mark.parametrize("size,cap", [(16, 4), (32, 8), (64, 16), (256, 16)])
def test_style_space_layout_matches_jax(size, cap):
    assert t_gen.generator_filters(size, cap) == j_gen.generator_filters(size, cap)
    assert t_gen.style_coord_dims(size, cap) == j_gen.style_coord_dims(size, cap)
    assert discriminator_filters(size, cap) == j_disc.discriminator_filters(size, cap)
    total = t_gen.num_style_coords(size, cap)
    assert total == j_gen.num_style_coords(size, cap)
    if (size, cap) == (64, 16):
        assert total == 2464
    for s in range(0, total, 7):
        assert (t_gen.sindex_to_block_and_offset(s, size, cap)
                == j_gen.sindex_to_block_and_offset(s, size, cap))
    with pytest.raises(IndexError):
        t_gen.sindex_to_block_and_offset(total, size, cap)


def test_synthetic_dataset_matches_jax():
    for seed in (0, 3):
        ours, theirs = SyntheticImageDataset(5, 16, seed=seed), JSynthetic(5, 16, seed=seed)
        assert len(ours) == len(theirs)
        for i in range(5):
            np.testing.assert_array_equal(ours[i], theirs[i])


@pytest.mark.parametrize("aug_prob", [0.0, 1.0])
def test_folder_dataset_matches_jax(tmp_path, monkeypatch, aug_prob):
    from PIL import Image

    from stylex_tpu import native

    # the JAX package's PIL path: its optional C++ resize is another
    # implementation of the same transform
    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.RandomState(0)
    (tmp_path / "sub").mkdir()
    for name, size, mode in (("a.png", (40, 24), "RGB"), ("sub/b.jpg", (18, 30), "RGB"),
                             ("c.png", (10, 12), "L")):
        shape = size[::-1] + ((3,) if mode == "RGB" else ())
        Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8), mode).save(tmp_path / name)
    ours = FolderDataset(str(tmp_path), 16, aug_prob=aug_prob, seed=1)
    theirs = j_dataset.FolderDataset(str(tmp_path), 16, aug_prob=aug_prob, seed=1)
    assert ours.paths == theirs.paths
    for i in range(len(ours)):
        got = ours[i]
        assert got.shape == (16, 16, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, theirs[i])


def test_reference_checkpoint_loads_and_drops_non_model_keys(tmp_path):
    cfg = ModelConfig(**TINY)
    sd = build_stylex(cfg, seed=3, device="cpu").state_dict()
    extra = {
        "D_aug.D.fc.weight": torch.zeros(1),
        "G.blocks.1.to_rgb.upsample.1.f": torch.ones(1, 3),
        "D.blocks.0.downsample.0.f": torch.ones(1, 3),
    }
    path = tmp_path / "model_1.pt"
    torch.save({"StylEx": {**sd, **extra}, "version": 1}, path)
    loaded = load_reference_checkpoint(str(path))
    assert set(loaded) == set(sd)
    model = StylEx(cfg)
    model.load_state_dict(loaded)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    torch.save(sd, tmp_path / "bare.pt")
    assert set(load_reference_checkpoint(str(tmp_path / "bare.pt"))) == set(sd)


def test_cli_splits_attfind_over_two_host_ranks(tmp_path):
    """``run_attfind``'s sweep on two host ranks: rank 0 writes the
    records, equal to the one process's within rtol 1e-4, atol 1e-5 (the
    ranks run on other torch thread counts, which sum the CPU convolutions
    in other orders; each rank sweeps its slice of every chunk, 63 rounded
    up to 64, the last one padded)."""
    cfg = ModelConfig(**TINY)
    ckpt, config = tmp_path / "model_1.pt", tmp_path / ".config.json"
    torch.save({"StylEx": build_stylex(cfg, seed=2, device="cpu").state_dict()}, ckpt)
    config.write_text(cfg.to_json())
    argv = ["--checkpoint", str(ckpt), "--config", str(config), "--classifier-name",
            "mobilenet", "--dataset-name", "synthetic", "--num-images", "2", "--coord-batch",
            "63", "--device", "cpu"]
    one = run_attfind.main(argv + ["--results-folder", str(tmp_path / "one")])
    # the CLI's rank function, as main launches it where two GPUs are present
    two = launch(run_attfind.extract, 2, "cpu",
                 args=(run_attfind.parse_args(argv + ["--results-folder", str(tmp_path / "two")]),))
    assert [r["rank"] for r in two] == [0, 1] and two[0]["styles"] == one[0]["styles"]
    want = j_load_records(str(tmp_path / "one" / "style_change_records.hdf5"))
    got = j_load_records(str(tmp_path / "two" / "style_change_records.hdf5"))
    for f in ("style_change", "latents", "base_prob", "style_coordinates", "discriminator"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    assert json.loads((tmp_path / "two" / "top_styles.json").read_text()) == json.loads(
        (tmp_path / "one" / "top_styles.json").read_text())


@pytest.mark.parametrize("resume", [True, False])
def test_cli_runs_attfind_on_cpu(tmp_path, capsys, resume):
    cfg = ModelConfig(**TINY)
    ckpt, config = tmp_path / "model_1.pt", tmp_path / ".config.json"
    torch.save({"StylEx": build_stylex(cfg, seed=2, device="cpu").state_dict()}, ckpt)
    config.write_text(cfg.to_json())
    clf_path = tmp_path / "mobilenet.pt"
    torch.save(build_classifier("mobilenet", 16, seed=2, device="cpu").net.state_dict(), clf_path)
    out = tmp_path / "results"
    argv = ["--checkpoint", str(ckpt), "--config", str(config),
            "--classifier-name", "mobilenet", "--classifier-path", str(clf_path),
            "--dataset-name", "synthetic", "--num-images", "2", "--coord-batch", "64",
            "--effect-threshold", "0.0", "--device", "cpu", "--results-folder", str(out)]
    run_attfind.main(argv + ([] if resume else ["--no-block-resume"]))
    assert "styles/s on cpu" in capsys.readouterr().out
    rec = j_load_records(str(out / "style_change_records.hdf5"))
    C = t_gen.num_style_coords(16, 4)
    assert rec.style_change.shape == (2, 2, C, 2)
    assert np.isfinite(rec.style_change).all()
    np.testing.assert_array_equal(rec.original_images,
                                  np.stack([SyntheticImageDataset(2, 16)[i] for i in range(2)]))
    top = json.loads((out / "top_styles.json").read_text())
    assert top["ranked"] and all(d in (0, 1) and 0 <= s < C for d, s in top["ranked"])


def test_cli_trains_with_attention_no_const_and_cl_reg(tmp_path):
    """Two training steps at the tiny config with the model and step
    options the CLI passes through; the checkpoint holds the attention and
    the no_const stem."""
    from stylex_tpu_torch import cli

    cli.main(["--dataset-name", "synthetic", "--device", "cpu", "--image-size", "16",
              "--network-capacity", "4", "--batch-size", "2", "--gradient-accumulate-every", "2",
              "--num-train-steps", "2", "--save-every", "1000", "--evaluate-every", "1000",
              "--classifier-name", "mobilenet", "--aug-prob", "0.0", "--num-image-tiles", "2",
              "--attn-layers", "[1]", "--no-const", "--cl-reg", "--name", "v",
              "--results-dir", str(tmp_path / "r"), "--models-dir", str(tmp_path / "m")])
    cfg = ModelConfig.from_json((tmp_path / "m" / "v" / ".config.json").read_text())
    assert cfg.attn_layers == (1,) and cfg.no_const
    sd = torch.load(tmp_path / "m" / "v" / "model_0.pt", weights_only=True)["StylEx"]
    assert "G.to_initial_block.weight" in sd and "G.initial_block" not in sd
    assert any(k.startswith("G.attns.2.") for k in sd)
    header, *rows = (tmp_path / "r" / "v" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 2 and "cr_loss" in header.split(",")


def _tiny_cli_args(tmp_path, name):
    return ["--dataset-name", "synthetic", "--device", "cpu", "--image-size", "16",
            "--network-capacity", "4", "--batch-size", "2", "--gradient-accumulate-every", "2",
            "--num-train-steps", "2", "--save-every", "1000", "--evaluate-every", "1000",
            "--classifier-name", "mobilenet", "--num-image-tiles", "2", "--name", name,
            "--tensorboard-dir", "None", "--results-dir", str(tmp_path / "r"),
            "--models-dir", str(tmp_path / "m")]


def test_cli_trains_on_two_host_ranks(tmp_path, capsys):
    """``--device cpu --num-devices 2``: two host ranks (gloo) train 2 steps,
    each on one image of every micro-batch; rank 0 alone writes the
    metrics (one row a step, the same losses the ranks share) and the one
    checkpoint. ``--multi-gpus`` is taken and prints the JAX CLI's no-op
    note."""
    from stylex_tpu_torch import cli

    cli.main(_tiny_cli_args(tmp_path, "dp") + ["--num-devices", "2", "--multi-gpus"])
    assert "--multi-gpus is a no-op" in capsys.readouterr().out
    header, *rows = (tmp_path / "r" / "dp" / "metrics.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(v)) for r in rows for v in r.split(",")[1:] if v)
    assert sorted(p.name for p in (tmp_path / "m" / "dp").iterdir()) == [".config.json",
                                                                           "model_0.pt"]
    ckpt = torch.load(tmp_path / "m" / "dp" / "model_0.pt", weights_only=False)
    assert int(ckpt["step"]) == 2


def test_cli_refuses_a_rank_count_that_does_not_divide_the_batch(tmp_path):
    from stylex_tpu_torch import cli

    with pytest.raises(ValueError, match="does not divide batch_size"):
        cli.main(_tiny_cli_args(tmp_path, "bad") + ["--num-devices", "3"])
    assert not (tmp_path / "m" / "bad").exists()
