"""Training CLI: the ``train_from_folder`` flags that the port supports.

    python -m stylex_tpu_torch.cli --data ./data/plants --image-size 64 \\
        --batch-size 4 --gradient-accumulate-every 8 --classifier-name resnet

Flags are ``--key value`` or ``--key=value``, kebab or snake case, with
Python literals for numbers, bools and lists; a bare flag means True. The
names and defaults are the JAX package's CLI's, plus ``--device`` (default:
the GPU; ``--device cpu`` runs on the host). TensorBoard scalars go to
``--tensorboard-dir`` (default ``tb_logs_stylex``; ``--tensorboard-dir
None`` turns them off), ``--log`` names the metrics CSV that stands in for
the reference's aim sink, and ``--dataset-name`` other than ``MNIST`` or
``synthetic`` trains from the ``--data`` folder. Every model and train-step
option of that CLI is taken: ``--attn-layers [1,2]``, ``--no-const``,
``--fq-layers [2] --fq-dict-size 256``, ``--encoder-class
PhillipEncoder64``, ``--remat``, ``--cl-reg``, ``--fused-microbatches
False`` (the scan step), beside the losses, augmentation and top-k
options; so are FID during training (``--calculate-fid-every N
--calculate-fid-num-images 12800 --clear-fid-cache``), the MNIST
one-vs-all set (``--dataset-name MNIST --data <folder of IDX files>
--image-size 32``) and the interpolation mode
(``--generate-interpolation --interpolation-num-steps 100
--save-frames``), and so are the host loop's knobs:
``--steps-per-dispatch K`` (K steps issued back to back, blocks clamped at
save / evaluate / FID steps) and ``--async-save`` (default True; ``False``
blocks on every save). A step whose losses go non-finite reloads the latest
checkpoint and is retried, 3 times at most.

Data parallelism: ``--num-devices N`` trains on N ranks, one process per
device (:func:`stylex_tpu_torch.parallel.launch`: GPU r for rank r, or N
host ranks under ``--device cpu``), each taking its slice of every
micro-batch; the training is the one process's on the same data and
draws, and rank 0 writes every file. The default is the JAX CLI's: the
largest count up to the GPUs present that divides ``--batch-size`` (1
under ``--device cpu``); at one device it runs in this process. A count
that does not divide the batch size, or more GPUs than are present, is
refused. ``--multi-gpus`` is a no-op, as in the JAX CLI.
"""

from __future__ import annotations

import ast
import inspect
import random as pyrandom
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig

__all__ = ["train_from_folder", "parse_argv", "main"]

def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


def train_from_folder(
    data: str = "./data",
    results_dir: str = "./results",
    models_dir: str = "./models",
    name: str = "default",
    new: bool = False,
    load_from: int = -1,
    image_size: int = 64,
    network_capacity: int = 16,
    fmap_max: int = 512,
    transparent: bool = False,
    batch_size: int = 4,
    gradient_accumulate_every: int = 8,
    num_train_steps: int = 150000,
    learning_rate: float = 2e-4,
    lr_mlp: float = 0.1,
    ttur_mult: float = 1.5,
    rel_disc_loss: bool = False,
    num_workers: Optional[int] = None,
    save_every: int = 500,
    evaluate_every: int = 50,
    generate: bool = False,
    num_generate: int = 1,
    generate_interpolation: bool = False,
    interpolation_num_steps: int = 100,
    save_frames: bool = False,
    num_image_tiles: int = 8,
    trunc_psi: float = 0.75,
    mixed_prob: float = 0.9,
    fp16: bool = False,
    bf16: bool = False,
    no_pl_reg: bool = False,
    cl_reg: bool = False,
    fq_layers: Sequence[int] = (),
    fq_dict_size: int = 256,
    attn_layers: Sequence[int] = (),
    no_const: bool = False,
    aug_prob: Optional[float] = None,
    aug_types: Sequence[str] = ("translation", "cutout"),
    top_k_training: bool = False,
    generator_top_k_gamma: float = 0.99,
    generator_top_k_frac: float = 0.5,
    dual_contrast_loss: bool = False,
    dataset_aug_prob: float = 0.0,
    calculate_fid_every: Optional[int] = None,
    calculate_fid_num_images: int = 12800,
    clear_fid_cache: bool = False,
    seed: int = 42,
    log: bool = False,
    kl_scaling: float = 1.0,
    rec_scaling: float = 1.0,
    classifier_path: Optional[str] = None,
    lpips_path: Optional[str] = None,
    num_classes: int = 2,
    encoder_class: Optional[str] = None,
    sample_from_encoder: bool = True,
    alternating_training: bool = True,
    kl_rec_during_disc: bool = False,
    dataset_name: Optional[str] = None,
    tensorboard_dir: Optional[str] = "tb_logs_stylex",
    classifier_name: str = "resnet",
    use_old_architecture: bool = True,
    remat: bool = False,
    fused_microbatches: bool = True,
    steps_per_dispatch: int = 1,
    async_save: bool = True,
    num_devices: Optional[int] = None,
    multi_gpus: bool = False,
    device: Optional[str] = None,
) -> None:
    """Train a StylEx model, or, with ``generate``, sample grids from it or,
    with ``generate_interpolation``, write an interpolation GIF; on
    ``num_devices`` ranks."""
    from stylex_tpu_torch.parallel import launch, make_mesh, resolve_num_devices

    if multi_gpus:
        print("--multi-gpus is a no-op here: use --num-devices to size the data-parallel "
              "group (one process per device).")
    num_devices = resolve_num_devices(num_devices, batch_size, device)
    model_cfg = ModelConfig(
        image_size=image_size, network_capacity=network_capacity, fmap_max=fmap_max,
        latent_dim=512 + num_classes, lr_mlp=lr_mlp, transparent=transparent,
        num_classes=num_classes, arch=Arch.OLD if use_old_architecture else Arch.NEW,
        attn_layers=_as_tuple(attn_layers), no_const=no_const, encoder_class=encoder_class,
        fq_layers=_as_tuple(fq_layers), fq_dict_size=fq_dict_size, remat=remat,
    )
    train_cfg = TrainConfig(
        batch_size=batch_size, gradient_accumulate_every=gradient_accumulate_every,
        lr=learning_rate, ttur_mult=ttur_mult,
        mixed_prob=mixed_prob, kl_scaling=kl_scaling, rec_scaling=rec_scaling,
        alternating_training=alternating_training, kl_rec_during_disc=kl_rec_during_disc,
        sample_from_encoder=sample_from_encoder, dual_contrast_loss=dual_contrast_loss,
        rel_disc_loss=rel_disc_loss, cl_reg=cl_reg, top_k_training=top_k_training,
        generator_top_k_gamma=generator_top_k_gamma,
        generator_top_k_frac=generator_top_k_frac, aug_prob=aug_prob, num_workers=num_workers,
        aug_types=_as_tuple(aug_types), dataset_aug_prob=dataset_aug_prob, no_pl_reg=no_pl_reg,
        save_every=save_every, evaluate_every=evaluate_every,
        calculate_fid_every=calculate_fid_every,
        calculate_fid_num_images=calculate_fid_num_images, trunc_psi=trunc_psi,
        num_image_tiles=num_image_tiles,
        compute_dtype="bfloat16" if (bf16 or fp16) else "float32",
        fused_microbatches=fused_microbatches, steps_per_dispatch=steps_per_dispatch,
        async_save=async_save, num_train_steps=num_train_steps, num_devices=num_devices,
    )
    trainer_kwargs = dict(name=name, results_dir=results_dir, models_dir=models_dir,
                          model_cfg=model_cfg, train_cfg=train_cfg,
                          classifier_name=classifier_name, classifier_path=classifier_path,
                          lpips_path=lpips_path, seed=seed, clear_fid_cache=clear_fid_cache,
                          tensorboard_dir=tensorboard_dir)
    run = dict(data=data, new=new, load_from=load_from, generate=generate,
               num_generate=num_generate, generate_interpolation=generate_interpolation,
               interpolation_num_steps=interpolation_num_steps, save_frames=save_frames,
               log=log, dataset_name=dataset_name)
    if num_devices > 1:
        launch(_train, num_devices, device, args=(trainer_kwargs, run))
    else:
        _train(make_mesh(1, device), trainer_kwargs, run)


def _train(mesh, trainer_kwargs: Dict[str, Any], run: Dict[str, Any]) -> None:
    """:func:`train_from_folder`'s work on one rank of ``mesh``: rank 0
    alone prints and writes files."""
    from stylex_tpu_torch.train.trainer import NanException, Trainer

    seed, name = trainer_kwargs["seed"], trainer_kwargs["name"]
    np.random.seed(seed)
    pyrandom.seed(seed)
    torch.manual_seed(seed)
    num_train_steps = trainer_kwargs["train_cfg"].num_train_steps
    trainer = Trainer(device=mesh.device, **trainer_kwargs)
    main = trainer.is_main
    if run["log"] and main:
        # the reference's log=True turns on its aim sink; the metrics CSV,
        # always on, takes its place here as in the JAX package
        print(f"[stylex_tpu_torch] --log: the aim sink is replaced by the metrics CSV "
              f"({trainer.results_dir / name / 'metrics.csv'}), which is always on")
    try:
        if run["generate"]:
            trainer.load(run["load_from"])
            if main:
                for i in range(run["num_generate"]):
                    trainer.evaluate(num=i)
                print(f"sample images generated under {trainer.results_dir / name}")
            return
        if run["generate_interpolation"]:
            trainer.load(run["load_from"])
            if main:
                out = trainer.generate_interpolation(
                    num=0, num_steps=run["interpolation_num_steps"],
                    save_frames=run["save_frames"])
                print(f"interpolation generated at {out}")
            return
        if run["new"]:
            trainer.clear()
        else:
            trainer.load(run["load_from"])
        trainer.set_data_src(run["data"], run["dataset_name"])
        while trainer.steps < num_train_steps:
            prev_steps = trainer.steps
            retries = 3
            while True:
                try:
                    metrics = trainer.train()
                    break
                except NanException:
                    retries -= 1
                    if retries <= 0:
                        raise
            # a block of several steps may pass over a multiple of 50
            if main and trainer.steps // 50 != prev_steps // 50:
                trainer.logger.print_line(trainer.steps, metrics)
        trainer.save(trainer.checkpoint_num)
        trainer.flush()  # the last save may be a write in flight
    finally:
        trainer.close()


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        low = v.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("none", "null"):
            return None
        return v


def parse_argv(argv: Sequence[str]) -> Dict[str, Any]:
    """``--key value`` / ``--key=value`` / bare ``--flag`` -> kwargs of
    :func:`train_from_folder`; anything else exits with a message."""
    known = set(inspect.signature(train_from_folder).parameters)
    kwargs: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected positional argument: {arg}")
        key = arg[2:]
        if "=" in key:
            key, val = key.split("=", 1)
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            i += 1
            val = argv[i]
        else:
            val = "True"
        key = key.replace("-", "_")
        if key not in known:
            raise SystemExit(f"--{key.replace('_', '-')} is not supported by stylex_tpu_torch")
        kwargs[key] = _parse_value(val)
        i += 1
    return kwargs


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print("usage: python -m stylex_tpu_torch.cli [--flag value ...]\n\nflags:")
        for p in inspect.signature(train_from_folder).parameters.values():
            print(f"  --{p.name.replace('_', '-')} (default: {p.default!r})")
        return
    train_from_folder(**parse_argv(argv))


if __name__ == "__main__":
    main()
