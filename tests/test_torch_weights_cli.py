"""The CLIs and trainer paths that load model files, on the CPU:
``set_data_src`` with a dataset name that is a folder (as the JAX trainer
reads it), ``run_attfind --name`` on a JAX package's checkpoint (records
equal to an in-process sweep of the same nets, bit for bit), the
counterfactual runner (``fid_results.csv`` equal to ``fid_topk``'s rows),
``train_classifier`` end to end, and the training CLI's ``--log`` and
``--tensorboard-dir``."""

import copy
import csv
import inspect
import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from stylex_tpu import cli as jcli
from stylex_tpu.config import ModelConfig as JModelConfig
from stylex_tpu.config import TrainConfig as JTrainConfig
from stylex_tpu.models import build_stylex as j_build_stylex
from stylex_tpu.models.classifiers import build_classifier as j_build_classifier
from stylex_tpu.train.state import create_train_state as j_create_train_state
from stylex_tpu.train.trainer import Trainer as JTrainer
from stylex_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from stylex_tpu_torch import cli, run_attfind, run_counterfactual, train_classifier
from stylex_tpu_torch.attfind import attfind_extraction, load_records, rank_styles, save_records
from stylex_tpu_torch.config import ModelConfig, TrainConfig
from stylex_tpu_torch.eval import counterfactual as cf
from stylex_tpu_torch.models import build_classifier
from stylex_tpu_torch.models.classifiers import imagenet_normalize
from stylex_tpu_torch.models.convert import stylex_state_dict_from_jax
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.ops.latents import image_noise
from stylex_tpu_torch.train.trainer import Trainer
from stylex_tpu_torch.data import SyntheticImageDataset

torch.set_num_threads(2)

TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)
SMALL_STEPS = ["--batch-size", "2", "--gradient-accumulate-every", "2", "--save-every", "1000",
               "--evaluate-every", "1000", "--classifier-name", "mobilenet", "--aug-prob", "0.0",
               "--num-image-tiles", "2", "--device", "cpu", "--network-capacity", "4"]


def _png_folder(path, n=4, size=64):
    rng = np.random.RandomState(0)
    path.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (size, size, 3), dtype=np.uint8)).save(
            path / f"{i}.png")
    return path


def test_set_data_src_reads_a_named_dataset_as_a_folder_like_jax(tmp_path):
    folder = _png_folder(tmp_path / "plants")
    kw = dict(image_size=64, network_capacity=4, latent_dim=34, encoder_dim=32)
    port = Trainer(name="p", base_dir=str(tmp_path / "p"), model_cfg=ModelConfig(**kw),
                   train_cfg=TrainConfig(batch_size=2, gradient_accumulate_every=1),
                   classifier_name="mobilenet", device="cpu")
    jt = JTrainer(name="j", base_dir=str(tmp_path / "j"), model_cfg=JModelConfig(**kw),
                  train_cfg=JTrainConfig(batch_size=2, gradient_accumulate_every=1,
                                         num_devices=1), classifier_name="mobilenet")
    try:
        port.set_data_src(str(folder), "plant_village")
        jt.set_data_src(str(folder), "plant_village")
        assert len(port.dataset) == len(jt.dataset) == 4
        for i in range(4):  # the JAX loader divides by 255 in its native decoder
            np.testing.assert_allclose(port.dataset[i], jt.dataset[i], rtol=0, atol=1e-6)
    finally:
        port.close()
        jt.loader.close()


def test_cli_trains_from_a_named_folder(tmp_path):
    folder = _png_folder(tmp_path / "plants", size=16)
    cli.main(["--data", str(folder), "--dataset-name", "plant_village", "--image-size", "16",
              "--num-train-steps", "1", "--name", "f", "--results-dir", str(tmp_path / "r"),
              "--models-dir", str(tmp_path / "m"), "--tensorboard-dir", "None", *SMALL_STEPS])
    assert (tmp_path / "m" / "f" / "model_0.pt").exists()


def test_log_and_tensorboard_flags(tmp_path, capsys):
    ours = inspect.signature(cli.train_from_folder).parameters
    theirs = inspect.signature(jcli.train_from_folder).parameters
    for flag in ("log", "tensorboard_dir"):
        assert ours[flag].default == theirs[flag].default, flag
    cli.main(["--dataset-name", "synthetic", "--image-size", "16", "--num-train-steps", "2",
              "--name", "tb", "--results-dir", str(tmp_path / "r"), "--models-dir",
              str(tmp_path / "m"), "--tensorboard-dir", str(tmp_path / "tb"), "--log",
              *SMALL_STEPS])
    assert "--log: the aim sink is replaced by the metrics CSV" in capsys.readouterr().out
    (events,) = (tmp_path / "tb" / "tb").glob("events.out.tfevents.*")
    data = events.read_bytes()
    for tag in (b"loss/G", b"loss/D", b"loss/rec", b"loss/kl"):
        assert data.count(tag) == 2, tag  # one scalar a step


def test_tensorboard_sink_off_without_the_module(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = Trainer(name="n", base_dir=str(tmp_path), model_cfg=ModelConfig(**TINY),
                      classifier_name="mobilenet", tensorboard_dir=str(tmp_path / "tb"),
                      device="cpu")
    out = capsys.readouterr().out
    assert out.count("TensorBoard sink off") == 1
    trainer.logger.log(0, {"g_loss": 1.0})
    assert trainer.logger.tb is None and not (tmp_path / "tb").exists()
    trainer.close()


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A JAX package's checkpoint ``models/m/model_1.ckpt`` with its
    ``.config.json``, and the same nets in the port."""
    base = tmp_path_factory.mktemp("jax_model")
    jcfg = JModelConfig(**TINY)
    state, _, _ = j_create_train_state(jax.random.PRNGKey(5), j_build_stylex(jcfg), jcfg,
                                       JTrainConfig())
    j_save_checkpoint(str(base / "models"), "m", 1, state)
    (base / "models" / "m" / ".config.json").write_text(jcfg.to_json())
    cfg = ModelConfig(**TINY)
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(
        jax.tree.map(np.asarray, state.full_params()), cfg))
    return base, model.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_attfind_by_name_on_a_jax_checkpoint(jax_model, tmp_path, dtype):
    base, model = jax_model
    out = tmp_path / "results"
    run_attfind.main(["--name", "m", "--base-dir", str(base), "--load-from", "1",
                      "--classifier-name", "mobilenet", "--dataset-name", "synthetic",
                      "--num-images", "2", "--coord-batch", "64", "--dtype", dtype,
                      "--device", "cpu", "--results-folder", str(out)])
    got = load_records(str(out / "style_change_records.hdf5"))
    torch_dtype = getattr(torch, dtype)
    clf = build_classifier("mobilenet", 16, device="cpu").to(torch_dtype)
    images = np.stack([SyntheticImageDataset(2, 16)[i] for i in range(2)])
    noise = image_noise(torch.Generator().manual_seed(42), 1, 16).numpy()
    want = attfind_extraction(copy.deepcopy(model).to(torch_dtype), clf.classify_images, images,
                              noise, coord_batch=64, compute_dtype=torch_dtype, progress=False)
    for f in ("style_change", "latents", "base_prob", "style_coordinates", "discriminator"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_run_counterfactual_writes_fid_topk_rows(jax_model, tmp_path):
    base, model = jax_model
    clf = build_classifier("mobilenet", 16, device="cpu")
    images = np.stack([SyntheticImageDataset(4, 16)[i] for i in range(4)])
    noise = image_noise(torch.Generator().manual_seed(42), 1, 16).numpy()
    records = attfind_extraction(model, clf.classify_images, images, noise, coord_batch=64,
                                 progress=False)
    att = tmp_path / "att"
    att.mkdir()
    save_records(records, str(att / "style_change_records.npz"))
    ranked, _ = rank_styles(records, effect_threshold=0.0)
    (att / "top_styles.json").write_text(json.dumps({"ranked": ranked}))
    fids = run_counterfactual.main(["--name", "m", "--base-dir", str(base), "--attfind-dir",
                                    str(att), "--classifier-name", "mobilenet", "--k", "2",
                                    "--batch-size", "4", "--device", "cpu"])
    want_csv = tmp_path / "want.csv"
    want = cf.fid_topk(model, clf.classify_images, records, ranked[:2], k=2, batch_size=4,
                       csv_path=str(want_csv))
    assert fids == want and len(fids) == 3 and all(np.isfinite(fids))
    assert list(csv.reader(open(att / "fid_results.csv"))) == list(csv.reader(open(want_csv)))
    with pytest.raises(FileNotFoundError):
        run_counterfactual.find_records(tmp_path)


@pytest.mark.parametrize("argv", [
    ["--model", "mobilenet", "--epochs", "1"],
    ["--model", "resnet", "--progressive", "--epochs", "3"],
])
def test_train_classifier_cli(tmp_path, argv):
    args = train_classifier.parse_args(
        ["--dataset", "synthetic", "--image-size", "32", "--batch-size", "32",
         "--saved-models-dir", str(tmp_path / "saved"), "--results-dir", str(tmp_path / "res"),
         "--tensorboard-dir", str(tmp_path / "tb"), "--device", "cpu", *argv])
    trainer, results = train_classifier.train(args)
    epochs = int(argv[-1])
    assert all(np.isfinite(results[f"epoch_{e}"]["loss"]) for e in range(epochs))
    assert json.loads((tmp_path / "res" / "classifier.msgpack.json").read_text()) == {
        "test_accuracy": results["test_accuracy"]}
    # the saved tree is the best epoch, which fit restored: the port reads
    # it back to the trainer's validation logits, the JAX package to
    # float32 rounding
    _, valid, _ = train_classifier.datasets(args)
    batch = next(train_classifier.labeled_batches(valid, len(valid), shuffle=False))[0]
    want = trainer.logits(batch)
    path = str(tmp_path / "saved" / "classifier.msgpack")
    clf = build_classifier(args.model, 32, checkpoint_path=path, device="cpu")
    x = imagenet_normalize(torch.from_numpy(batch).permute(0, 3, 1, 2).float() / 255.0)
    with torch.no_grad():
        assert torch.equal(clf.net(x), want)
    jclf = j_build_classifier(args.model, 32, checkpoint_path=path)
    got = np.asarray(jclf.apply_fn(jclf.variables, x.permute(0, 2, 3, 1).numpy()))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
