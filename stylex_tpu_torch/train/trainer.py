"""Trainer: the host-side training loop around the train step.

It owns model and optimizer construction, the data source (an image folder,
MNIST one-vs-all with class-rebalanced sampling, or the synthetic set, with
the reference's automatic augmentation probability for small datasets),
the step's random draws (a ``torch.Generator`` on the device, seeded),
checkpoints with the model's ``.config.json`` (the port's ``.pt`` or the
JAX package's ``.ckpt``, in full or for inference), TensorBoard scalars
under ``tensorboard_dir``, the save, evaluate and FID
cadence, evaluation grids, slerp interpolation GIFs, and the NaN fault
path: non-finite losses reload the latest checkpoint and raise
:class:`NanException`, which the CLI retries.

FID (:meth:`Trainer.calculate_fid`) compares real batches from the loader
with EMA samples, by :func:`stylex_tpu_torch.eval.fid.resolve_feature_fn`'s
extractor; the real side's statistics are cached under
``fid/<name>/real_stats.npz``, keyed by the extractor's tag and the sample
count. :class:`ModelLoader` wraps a checkpoint for inference.

Runs on the GPU unless ``device='cpu'`` is given; without a GPU it raises.
A float32 trainer turns TF32 off (:func:`set_float32_precision`), as the
float32 AttFind sweep does.

The host loop is pipelined as the JAX package's is. ``train()`` runs a
block of up to ``steps_per_dispatch`` steps back to back with no host read
between them (the block ends at every save / evaluate / FID step), draws
the block's randomness in sequential order, and queues the block's metrics:
they stay on the device, copying to pinned host memory without blocking.
A queued block is read, logged and NaN-checked as soon as its copy has
landed (on the CPU, where a step has finished when it returns, at once),
and the host waits for one only when more than ``metrics_lag // k`` blocks
are queued. The first step and every boundary read all. So a NaN is caught
at most ``max(metrics_lag, k) + k - 1`` steps late for blocks of k steps
(``metrics_lag`` for one-step blocks), and every save drains first.
Checkpoints go through an
:class:`~stylex_tpu_torch.utils.checkpoint.AsyncCheckpointWriter` with
``async_save``. ``train()`` returns the latest metrics read and the
:class:`~stylex_tpu_torch.utils.profiling.StepTimer`'s rates: on a GPU from
the CUDA events that end the blocks (a block's time is the device's from the
previous block's event, or from an event recorded before it where the clock
starts: the first block, and the first after save, evaluate, FID or a load),
on the CPU from the host's clock around the block.

The host loop's spans (:mod:`stylex_tpu_torch.utils.tracing`): ``train.block``
per call (attribute ``k``), with ``train.data_wait`` per take from the
loader's queue, ``train.draws``, ``train.step`` per step (unit: the step
number; its phases are ``train/steps.py``'s), ``train.drain`` with a
``train.wait`` where a queued block's copy had not landed, and
``train.save``, ``train.evaluate``, ``train.fid``.

Data parallelism: built inside a worker of
:func:`stylex_tpu_torch.parallel.launch`, the trainer is one rank of the
group (``num_devices``, when set, must be its size; built outside one,
``num_devices`` above 1 raises). Every rank builds the same model, draws the
same global index order and step draws, and loads its slice of each
micro-batch; the step gathers where the losses couple the samples and sums
the gradients (:func:`~stylex_tpu_torch.train.steps.make_train_step`), so
the ranks' states and metrics stay equal. Rank 0 alone writes the config,
the metrics CSV, TensorBoard, checkpoints, sample grids, FID and GIFs; every
save ends at a barrier, every load starts at one and broadcasts rank 0's
state. With several ranks on GPUs a queued block of metrics is read only
when the lag forces it (never on a copy's landing, which differs between
ranks), so that every rank meets a NaN at the same step.
"""

from __future__ import annotations

import math
import shutil
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from stylex_tpu_torch import __version__
from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig
from stylex_tpu_torch.data import (
    FolderDataset,
    MNIST1vA,
    StepBatchLoader,
    SyntheticImageDataset,
    as_float01,
    balanced_class_weights,
)
from stylex_tpu_torch.device import set_float32_precision, to_host_async
from stylex_tpu_torch.eval.fid import compute_feature_stats, frechet_distance, resolve_feature_fn
from stylex_tpu_torch.models.classifiers import build_classifier
from stylex_tpu_torch.models.lpips import init_lpips_params, load_lpips_params
from stylex_tpu_torch.models.stylex import build_stylex, make_w
from stylex_tpu_torch.ops.latents import (
    expand_styles,
    image_noise,
    latent_noise,
    mixed_w_styles,
    slerp,
    truncate_w,
)
from stylex_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated
from stylex_tpu_torch.train.state import TrainState, create_train_state
from stylex_tpu_torch.train.steps import StepDraws, draw_step, make_train_step
from stylex_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_path,
    find_checkpoint,
    latest_checkpoint,
    load_any_checkpoint,
    load_checkpoint_inference,
    save_checkpoint,
)
from stylex_tpu_torch.utils.image import make_grid, save_image_grid, to_uint8
from stylex_tpu_torch.utils.logging import MetricLogger
from stylex_tpu_torch.utils import tracing
from stylex_tpu_torch.utils.profiling import StepTimer

__all__ = ["Trainer", "NanException", "ModelLoader"]


class NanException(Exception):
    """Losses went non-finite; the latest checkpoint has been reloaded."""


class _Pending:
    """The metrics of a block of steps from ``step`` on, bound for the host:
    one (steps, keys) float64 tensor (exact for float32 and float64 losses),
    copied into pinned memory without blocking where it lies on a GPU, with
    a timing event at the copy's end."""

    def __init__(self, step: int, metrics: List[Dict[str, torch.Tensor]], device):
        self.step = step
        self.keys = list(metrics[0])
        rows = torch.stack([torch.stack([torch.as_tensor(m[k], device=device).detach()
                                         .to(torch.float64).reshape(()) for k in self.keys])
                            for m in metrics])
        self.rows = to_host_async(rows)
        self.event = None
        if rows.is_cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()

    def ready(self) -> bool:
        """Whether the host copy has landed: reading it then waits for
        nothing."""
        return self.event is None or self.event.query()

    def read(self) -> List[Dict[str, float]]:
        if self.event is not None and not self.event.query():
            with tracing.span("train.wait"):
                self.event.synchronize()
        return [dict(zip(self.keys, row)) for row in self.rows.tolist()]


class Trainer:
    def __init__(self, name: str = "default", results_dir: str = "results",
                 models_dir: str = "models", base_dir: str = "./",
                 model_cfg: Optional[ModelConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, classifier_name: str = "resnet",
                 classifier_path: Optional[str] = None, lpips_path: Optional[str] = None,
                 seed: int = 42, clear_fid_cache: bool = False,
                 tensorboard_dir: Optional[str] = None, device=None):
        self.model_cfg = model_cfg or ModelConfig()
        self.train_cfg = train_cfg or TrainConfig()
        # in a launched worker, its rank (and the rank's device)
        self.mesh = make_mesh(self.train_cfg.num_devices, device)
        self.device = self.mesh.device
        self.is_main = self.mesh.rank == 0
        self.name = name
        base = Path(base_dir)
        self.results_dir = base / results_dir
        self.models_dir = base / models_dir
        self.fid_dir = base / "fid" / name
        self.config_path = self.models_dir / name / ".config.json"
        if not math.log2(self.model_cfg.image_size).is_integer():
            raise ValueError("image size must be a power of 2")
        if self.train_cfg.compute_dtype == "float32":
            set_float32_precision()
        self.seed = seed
        self._classifier_name, self._classifier_path = classifier_name, classifier_path
        self._build_classifier()
        if lpips_path is not None:
            self.lpips_params = load_lpips_params(lpips_path, self.device)
        else:
            print("[stylex_tpu_torch] no lpips_path: the reconstruction loss uses the seeded "
                  "random AlexNet perceptual metric, not the pretrained LPIPS-alex")
            self.lpips_params = init_lpips_params(device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state: Optional[TrainState] = None
        self._inference_only = False
        self._step_fn = None
        self.loader: Optional[StepBatchLoader] = None
        self.dataset = None
        self.aug_prob = self.train_cfg.aug_prob
        self.clear_fid_cache = clear_fid_cache
        self.last_fid: Optional[float] = None
        self.logger = MetricLogger(str(self.results_dir / name / "metrics.csv"),
                                   tensorboard_dir=tensorboard_dir, name=name) \
            if self.is_main else MetricLogger()
        self._pending: deque = deque()  # _Pending blocks, oldest first
        self._last_metrics: Dict[str, float] = {}
        self._ckpt_writer = AsyncCheckpointWriter()
        self.step_timer = StepTimer()
        self.init_folders()

    # ------------------------------------------------------------------ setup
    def _build_classifier(self) -> None:
        cfg = self.model_cfg
        self.classifier = build_classifier(self._classifier_name, cfg.image_size,
                                           cfg.num_classes, self._classifier_path,
                                           device=self.device)
        self.classifier.net.requires_grad_(False)

    @property
    def steps(self) -> int:
        return self.state.step if self.state is not None else 0

    @property
    def checkpoint_num(self) -> int:
        return self.steps // self.train_cfg.save_every

    def init_stylex(self) -> None:
        """Build the model (from ``seed``), its optimizers and the step,
        once."""
        if self.state is not None:
            return
        model = build_stylex(self.model_cfg, seed=self.seed, device=self.device)
        replicated(self.mesh, model)
        self.state = create_train_state(model, self.model_cfg, self.train_cfg)
        self._build_step_fn()
        self.write_config()

    def _build_step_fn(self) -> None:
        self._step_fn = make_train_step(self.model_cfg, self.train_cfg,
                                        self.classifier.classify_images, self.lpips_params,
                                        aug_prob=self.aug_prob or 0.0, mesh=self.mesh)

    def init_folders(self) -> None:
        (self.results_dir / self.name).mkdir(parents=True, exist_ok=True)
        (self.models_dir / self.name).mkdir(parents=True, exist_ok=True)

    def clear(self) -> None:
        self._ckpt_writer.wait()  # a write in flight would bring a file back
        if self.is_main:
            for d in (self.models_dir / self.name, self.results_dir / self.name, self.fid_dir):
                shutil.rmtree(d, ignore_errors=True)
        self.mesh.barrier()
        self.init_folders()

    def write_config(self) -> None:
        if self.is_main:
            self.config_path.write_text(self.model_cfg.to_json())

    def load_config(self) -> None:
        if not self.config_path.exists():
            return
        cfg = ModelConfig.from_json(self.config_path.read_text())
        if cfg != self.model_cfg:
            if self.state is not None:
                raise ValueError(f"{self.config_path} does not match the built model")
            self.model_cfg = cfg
            self._build_classifier()

    # ------------------------------------------------------------------- data
    def set_data_src(self, folder: str = "./", dataset_name: Optional[str] = None) -> None:
        tc = self.train_cfg
        weights = None
        if dataset_name == "MNIST":
            self.dataset = MNIST1vA(folder, digit=8)
            weights = balanced_class_weights(self.dataset.targets, self.model_cfg.num_classes)
        elif dataset_name == "synthetic":
            self.dataset = SyntheticImageDataset(512, self.model_cfg.image_size)
        else:  # any other name (or none) is a folder of images, as in the JAX package
            self.dataset = FolderDataset(folder, self.model_cfg.image_size,
                                         transparent=self.model_cfg.transparent,
                                         aug_prob=tc.dataset_aug_prob, seed=self.seed)
        kwargs = {} if tc.num_workers is None else {"num_workers": tc.num_workers}
        if self.loader is not None:
            self.loader.close()
        self.loader = StepBatchLoader(self.dataset, tc.batch_size, tc.gradient_accumulate_every,
                                      seed=self.seed, weights=weights,
                                      need_g_real=tc.dual_contrast_loss,
                                      shard=data_sharding(self.mesh, tc.batch_size), **kwargs)
        if self.aug_prob is None and len(self.dataset) < 1e5:
            self.aug_prob = min(0.5, (1e5 - len(self.dataset)) * 3e-6)
            print(f"autosetting augmentation probability to {round(self.aug_prob * 100)}%")
            if self.state is not None:
                self._build_step_fn()

    def close(self) -> None:
        """Log the metrics in flight (up to a non-finite step, if any), join
        the checkpoint writer, stop the loader's threads and close the
        TensorBoard file."""
        try:
            self._drain(0, reload_on_nan=False)
            self._ckpt_writer.wait()
        finally:
            if self.loader is not None:
                self.loader.close()
                self.loader = None
            self.logger.close()

    # ------------------------------------------------------------------ train
    def _top_k(self, step: int) -> int:
        tc = self.train_cfg
        epochs = step * tc.batch_size * tc.gradient_accumulate_every / max(len(self.dataset), 1)
        return math.ceil(tc.batch_size * max(tc.generator_top_k_gamma ** epochs,
                                             tc.generator_top_k_frac))

    def _is_boundary(self, step: int) -> bool:
        """Steps after which the host has periodic work: save, evaluate or
        FID."""
        tc = self.train_cfg
        return (step % tc.save_every == 0
                or step % tc.evaluate_every == 0
                or (step % 100 == 0 and step < 2500)
                or (tc.calculate_fid_every is not None and step % tc.calculate_fid_every == 0
                    and step != 0))

    def train(self, draws: Optional[StepDraws] = None) -> Dict[str, float]:
        """One block of steps, then the save / evaluate / FID work of its
        last step. The block is the largest k <= ``steps_per_dispatch`` whose
        only boundary step is its last and that stops at
        ``num_train_steps``; ``draws`` (the first step's draws, default the
        trainer's generator) makes it one step. Returns the latest metrics
        read (:meth:`_drain`) with ``step_time_s``, ``steps_per_sec`` and
        ``imgs_per_sec``."""
        if self.loader is None:
            raise RuntimeError("call set_data_src before train")
        if self._inference_only:
            raise RuntimeError("Trainer.load(inference=True) placed only the parameters on the "
                               "device and no optimizer state; call load(num) before train()")
        self.init_stylex()
        tc = self.train_cfg
        step = self.steps
        k, limit = 1, 1 if draws is not None else max(1, tc.steps_per_dispatch)
        while (k < limit and not self._is_boundary(step + k - 1)
               and step + k < tc.num_train_steps):
            k += 1
        with tracing.span("train.block", k=k):
            return self._block(step, k, draws)

    def _block(self, step: int, k: int, draws: Optional[StepDraws]) -> Dict[str, float]:
        tc = self.train_cfg
        # the block's batches and draws in sequential order: a k-step block
        # consumes exactly the data and randomness of k one-step calls
        batches = []
        for i in range(k):
            batch = next(self.loader)
            if tc.top_k_training:
                batch["top_k"] = self._top_k(step + i)
            batches.append(batch)
        with tracing.span("train.draws"):
            block_draws = [draws if draws is not None else draw_step(
                self.generator, self.model_cfg, tc, tc.batch_size,
                self.state.model.num_layers, self.aug_prob or 0.0, step + i) for i in range(k)]
        last = step + k - 1
        on_gpu = self.state.device.type == "cuda"
        if on_gpu and self.step_timer.last_event is None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.step_timer.mark(start)
        t0 = time.perf_counter()
        metrics = []
        for i, (b, d) in enumerate(zip(batches, block_draws)):
            with tracing.span("train.step", unit=step + i):
                metrics.append(self._step_fn(self.state, b, d))
        self._pending.append(_Pending(step, metrics, self.state.device))
        drain_all = (self._is_boundary(last) or not self._last_metrics
                     or tc.metrics_lag == 0)
        with tracing.span("train.drain"):
            self._drain(0 if drain_all else max(1, tc.metrics_lag // k))
        if not on_gpu:
            self.step_timer.add(time.perf_counter() - t0)
        out = dict(self._last_metrics)
        out.update(self.step_timer.stats(
            images_per_step=k * tc.batch_size * tc.gradient_accumulate_every))

        save = last % tc.save_every == 0
        if save:
            with tracing.span("train.save"):
                self.save(last // tc.save_every)
        evaluate = last % tc.evaluate_every == 0 or (last % 100 == 0 and last < 2500)
        fid = tc.calculate_fid_every is not None and last % tc.calculate_fid_every == 0 and last != 0
        if evaluate and self.is_main:
            with tracing.span("train.evaluate"):
                self.evaluate(encoder_input=tc.sample_from_encoder, num=last // tc.evaluate_every)
        if fid and self.is_main:
            with tracing.span("train.fid"):
                num_batches = math.ceil(tc.calculate_fid_num_images / tc.batch_size)
                self.last_fid = self.calculate_fid(num_batches)
                with open(self.results_dir / self.name / "fid_scores.txt", "a") as f:
                    f.write(f"{last},{self.last_fid}\n")
        if evaluate or fid:
            self._sync_loader()
        if save or evaluate or fid:
            self.step_timer.restart()  # the queue is empty: every block is read
        return out

    def _sync_loader(self) -> None:
        """Rank 0's evaluation and FID took real batches from the loader's
        stream; the other ranks drop as many, so that every rank's next
        batch is the same one."""
        if self.mesh.group is None:
            return
        samples = self.loader.sample_loader
        pulled = torch.tensor([samples.pulled], dtype=torch.int64, device=self.device)
        replicated(self.mesh, pulled)
        samples.skip(int(pulled) - samples.pulled)

    def _landed(self, block: _Pending) -> bool:
        """Whether a queued block can be read without waiting. GPU ranks'
        copies land at different times, so across them the lag alone
        decides, the same on every rank."""
        return block.ready() if self.mesh.group is None or block.event is None else False

    def _drain(self, lag: int, reload_on_nan: bool = True) -> None:
        """Read, log and NaN-check queued blocks: every block whose copy has
        landed, and older ones until at most ``lag`` are queued. A
        non-finite ``g_loss`` or ``d_loss`` drops the queue and, with
        ``reload_on_nan``, reloads the latest checkpoint and raises
        :class:`NanException`; without it, stops logging there."""
        while self._pending and (len(self._pending) > lag or self._landed(self._pending[0])):
            block = self._pending.popleft()
            for i, metrics in enumerate(block.read()):
                if not (math.isfinite(metrics["g_loss"]) and math.isfinite(metrics["d_loss"])):
                    self._pending.clear()
                    if not reload_on_nan:
                        return
                    print(f"NaN detected for generator or discriminator at step "
                          f"{block.step + i}. Loading the latest checkpoint")
                    self.load(-1)
                    raise NanException
                self.logger.log(block.step + i, metrics)
                self._last_metrics = metrics
            if block.event is not None:
                self.step_timer.mark(block.event)

    # ----------------------------------------------------------- persistence
    def save(self, num: int) -> str:
        """Checkpoint ``num`` of the current state, after reading every
        queued metric (a NaN state is never saved); in the background with
        ``async_save``; written by rank 0, every rank meeting at a barrier
        after. Returns the file's path."""
        self._drain(0)
        self.write_config()
        extra = {"version": __version__}
        if self.is_main and self.train_cfg.async_save:
            self._ckpt_writer.submit(str(self.models_dir), self.name, num, self.state,
                                     extra=extra)
        elif self.is_main:
            self._ckpt_writer.wait()
            save_checkpoint(str(self.models_dir), self.name, num, self.state, extra=extra)
        self.mesh.barrier()
        return str(checkpoint_path(str(self.models_dir), self.name, num))

    def flush(self) -> None:
        """Read, log and NaN-check every queued metric and join the
        checkpoint writer: after it, every step is logged and every save is
        on disk."""
        self._drain(0)
        self._ckpt_writer.wait()

    def load(self, num: int = -1, inference: bool = False, ship_ema: bool = True,
             param_dtype: Optional[torch.dtype] = None) -> None:
        """Restore checkpoint ``num``, the port's ``model_<num>.pt`` or the
        JAX package's ``model_<num>.ckpt`` (the latest of either for -1; none
        found: keep the fresh model). A stored step of 0 becomes ``num *
        save_every``, as the reference counts it.

        ``inference=True`` builds the model on the host, loads it there and
        places only the parameters on the device (cast to ``param_dtype``
        where float32; the EMA copies too when ``ship_ema``), with no
        optimizer state: :meth:`train` then raises until a full load.

        The metrics in flight are logged first (up to a non-finite step, if
        any) and the checkpoint writer is joined: a save in flight may be the
        file read here. Every rank loads, after a barrier that rank 0's
        writes precede; a full load then broadcasts rank 0's state."""
        self._drain(0, reload_on_nan=False)
        self._ckpt_writer.wait()
        self.step_timer.restart()
        self.mesh.barrier()
        self.load_config()
        if num == -1:
            found = latest_checkpoint(str(self.models_dir), self.name)
            if found is None:
                self.init_stylex()
                return
            num, path = found
        else:
            path = str(find_checkpoint(str(self.models_dir), self.name, num))
        if inference:
            model = build_stylex(self.model_cfg, seed=self.seed, device="cpu")
            self.state = create_train_state(model, self.model_cfg, self.train_cfg)
            load_checkpoint_inference(path, self.state, ship_ema=ship_ema,
                                      param_dtype=param_dtype, device=self.device)
        else:
            if self._inference_only:
                self.state = None
            self.init_stylex()
            load_any_checkpoint(path, self.state)
            replicated(self.mesh, [self.state.model, self.state.pl_mean,
                                   [list(opt.state.values())
                                    for opt in (self.state.g_opt, self.state.d_opt)]])
        self._inference_only = inference
        if self.state.step == 0:
            self.state.step = num * self.train_cfg.save_every

    # ------------------------------------------------------------ evaluation
    @torch.no_grad()
    def style_mean(self) -> torch.Tensor:
        """The live S's mean w over 2000 z, the truncation centre (the
        reference takes the live S even when generating with the EMA
        nets)."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        z = latent_noise(gen, 2000, self.model_cfg.mapping_dim, device=self.device)
        return self.state.model.map_z(z).mean(dim=0, keepdim=True)

    def truncated_w(self, w: torch.Tensor) -> torch.Tensor:
        """The truncation trick around :meth:`style_mean`."""
        return truncate_w(w, self.style_mean(), self.train_cfg.trunc_psi)

    @torch.no_grad()
    def generate_images(self, w_styles, noise, ema: bool = False) -> np.ndarray:
        rgb, _ = self.state.model.generate(w_styles, noise, ema=ema)
        return rgb.clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()

    def _uniform_probs(self, gen: torch.Generator, n: int) -> torch.Tensor:
        p = torch.rand(n, self.model_cfg.num_classes, generator=gen, device=self.device)
        return p / p.sum(dim=1, keepdim=True)

    @torch.no_grad()
    def evaluate(self, encoder_input: bool = False, num: int = 0) -> None:
        """Sample grids, truncated: ``{num}.png`` (live nets),
        ``{num}-ema.png`` (EMA nets), ``{num}-mr.png`` (style mixing, EMA)
        and, with ``encoder_input``, ``{num}-from_encoder[-ema].png`` (real
        images above their reconstructions)."""
        self.init_stylex()
        cfg, model = self.model_cfg, self.state.model
        rows = self.train_cfg.num_image_tiles
        total, L = rows * rows, model.num_layers
        gen = torch.Generator(device=self.device).manual_seed(num)
        noise = image_noise(gen, total, cfg.image_size, device=self.device)
        out = self.results_dir / self.name

        if encoder_input and self.loader is not None:
            real = torch.as_tensor(next(self.loader.sample_loader)).to(self.device)
            real = (real.float() / 255.0 if real.dtype == torch.uint8 else real.float())
            real = real.permute(0, 3, 1, 2).contiguous()
            logits = self.classifier.classify_images(real)
            enc = model.encode(real)
            if cfg.arch == Arch.NEW:
                w = torch.cat([self.truncated_w(enc), torch.softmax(logits, dim=-1)], dim=-1)
            else:
                w = self.truncated_w(make_w(cfg, enc, logits))
            enc_noise = noise[:real.shape[0]]
            for ema, suffix in ((False, ""), (True, "-ema")):
                fake = self.generate_images(expand_styles(w, L), enc_noise, ema=ema)
                panel = np.concatenate([real.permute(0, 2, 3, 1).cpu().numpy(), fake])
                save_image_grid(panel, str(out / f"{num}-from_encoder{suffix}.png"),
                                real.shape[0])

        z = latent_noise(gen, total, cfg.mapping_dim, device=self.device)
        for ema, suffix in ((False, ""), (True, "-ema")):
            w = self.truncated_w(model.map_z(z, ema=ema))
            if cfg.arch == Arch.NEW:
                w = torch.cat([w, self._uniform_probs(gen, total)], dim=-1)
            save_image_grid(self.generate_images(expand_styles(w, L), noise, ema=ema),
                            str(out / f"{num}{suffix}.png"), rows)

        # style-mixing regularities: column styles below layer L // 2, row
        # styles from it on
        w1 = model.map_z(latent_noise(gen, rows, cfg.mapping_dim, device=self.device), ema=True)
        w2 = model.map_z(latent_noise(gen, rows, cfg.mapping_dim, device=self.device), ema=True)
        wmix = mixed_w_styles(w2.repeat(rows, 1), w1.repeat_interleave(rows, dim=0), L // 2, L)
        if cfg.arch == Arch.NEW:
            probs = self._uniform_probs(gen, total)[:, None].expand(total, L, cfg.num_classes)
            wmix = torch.cat([wmix, probs], dim=-1)
        save_image_grid(self.generate_images(wmix, noise, ema=True), str(out / f"{num}-mr.png"),
                        rows)

    @torch.no_grad()
    def generate_interpolation(self, num: int = 0, num_steps: int = 100,
                               num_rows: Optional[int] = None, save_frames: bool = False) -> str:
        """A looping GIF (80 ms a frame) of ``num_rows``² truncated EMA
        samples moving along slerp paths between two z draws, ratios
        ``linspace(0, 8, num_steps)`` as the reference has them, to
        ``results/<name>/{num}.gif``; with ``save_frames`` also each frame as
        ``results/<name>/{num}/{i}.png``. Returns the GIF's path."""
        from PIL import Image

        self.init_stylex()
        cfg, model = self.model_cfg, self.state.model
        n = num_rows or self.train_cfg.num_image_tiles
        total, L = n * n, model.num_layers
        gen = torch.Generator(device=self.device).manual_seed(num)
        noise = image_noise(gen, total, cfg.image_size, device=self.device)
        z_low = latent_noise(gen, total, cfg.mapping_dim, device=self.device)
        z_high = latent_noise(gen, total, cfg.mapping_dim, device=self.device)
        av = self.style_mean()
        frames = []
        for ratio in np.linspace(0.0, 8.0, num_steps):
            w = truncate_w(model.map_z(slerp(float(ratio), z_low, z_high), ema=True), av,
                           self.train_cfg.trunc_psi)
            if cfg.arch == Arch.NEW:
                w = torch.cat([w, torch.full((total, cfg.num_classes), 1.0 / cfg.num_classes,
                                             device=self.device)], dim=-1)
            imgs = self.generate_images(expand_styles(w, L), noise, ema=True)
            frames.append(Image.fromarray(make_grid(to_uint8(imgs), nrow=n)))
        out = self.results_dir / self.name / f"{num}.gif"
        frames[0].save(out, save_all=True, append_images=frames[1:], duration=80, loop=0)
        if save_frames:
            fdir = self.results_dir / self.name / f"{num}"
            fdir.mkdir(exist_ok=True)
            for i, frame in enumerate(frames):
                frame.save(fdir / f"{i}.png")
        return str(out)

    # -------------------------------------------------------------------- FID
    def fid_draws(self, i: int, b: int):
        """z and noise of :meth:`calculate_fid`'s fake batch ``i`` (``b``
        images), from a generator seeded with ``i``."""
        gen = torch.Generator(device=self.device).manual_seed(i)
        return (latent_noise(gen, b, self.model_cfg.mapping_dim, device=self.device),
                image_noise(gen, b, self.model_cfg.image_size, device=self.device))

    @torch.no_grad()
    def calculate_fid(self, num_batches: int, eval_batch_images: int = 64) -> float:
        """FID between ``num_batches`` train batches of real images and as
        many EMA samples (no truncation; on the NEW arch with uniform class
        probabilities). The images are regrouped into batches of
        ``eval_batch_images``.

        The real side's statistics are cached in ``fid/<name>/real_stats.npz``
        and reused when the extractor's tag and ``num_batches`` match;
        ``clear_fid_cache`` recomputes them once."""
        self.init_stylex()
        cfg, tc, model = self.model_cfg, self.train_cfg, self.state.model
        L = model.num_layers
        total = num_batches * tc.batch_size
        group = max(1, eval_batch_images // tc.batch_size)

        def real_batches():
            done = 0
            while done < total:
                k = min(group, math.ceil((total - done) / tc.batch_size))
                yield as_float01(np.concatenate(
                    [np.asarray(next(self.loader.sample_loader)) for _ in range(k)]))
                done += k * tc.batch_size

        def fake_batches():
            done = i = 0
            while done < total:
                b = min(group * tc.batch_size, total - done)
                z, noise = self.fid_draws(i, b)
                i += 1
                w = model.map_z(z, ema=True)
                if cfg.arch == Arch.NEW:
                    w = torch.cat([w, torch.full((b, cfg.num_classes), 1.0 / cfg.num_classes,
                                                 device=self.device)], dim=-1)
                yield self.generate_images(expand_styles(w, L), noise, ema=True)
                done += b

        feature_fn = resolve_feature_fn(device=self.device)
        cache = self.fid_dir / "real_stats.npz"
        mu_r = cov_r = None
        if cache.exists() and not self.clear_fid_cache:
            d = np.load(cache, allow_pickle=False)
            if ("extractor" in d.files and str(d["extractor"]) == feature_fn.tag
                    and "num_batches" in d.files and int(d["num_batches"]) == num_batches):
                mu_r, cov_r = d["mu"], d["cov"]
        if mu_r is None:
            mu_r, cov_r = compute_feature_stats(real_batches(), feature_fn)
            self.fid_dir.mkdir(parents=True, exist_ok=True)
            np.savez(cache, mu=mu_r, cov=cov_r, extractor=np.str_(feature_fn.tag),
                     num_batches=num_batches)
            self.clear_fid_cache = False
        mu_f, cov_f = compute_feature_stats(fake_batches(), feature_fn)
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)


class ModelLoader:
    """A checkpoint (the port's ``.pt`` or the JAX package's ``.ckpt``) for
    inference: z -> w -> images with the live nets, loaded by
    ``Trainer.load(inference=True)``."""

    def __init__(self, base_dir: str = "./", name: str = "default", load_from: int = -1,
                 model_cfg: Optional[ModelConfig] = None, classifier_name: str = "resnet",
                 classifier_path: Optional[str] = None, device=None):
        self.trainer = Trainer(name=name, base_dir=base_dir, model_cfg=model_cfg,
                               classifier_name=classifier_name,
                               classifier_path=classifier_path, device=device)
        self.trainer.load(load_from, inference=True)

    @torch.no_grad()
    def noise_to_styles(self, noise: torch.Tensor,
                        trunc_psi: Optional[float] = None) -> torch.Tensor:
        """(B, mapping_dim) z -> (B, w) through the live S, truncated
        toward the mean w with ``trunc_psi``."""
        w = self.trainer.state.model.map_z(noise)
        if trunc_psi is not None:
            w = truncate_w(w, self.trainer.style_mean(), trunc_psi)
        return w

    def styles_to_images(self, w: torch.Tensor) -> np.ndarray:
        """(B, w) or (B, layers, w) -> (B, S, S, 3) images in [0, 1] from the
        live G, with zero noise."""
        cfg = self.trainer.model_cfg
        if w.dim() == 2:
            w = expand_styles(w, self.trainer.state.model.num_layers)
        noise = torch.zeros(w.shape[0], cfg.image_size, cfg.image_size, 1, device=w.device)
        return self.trainer.generate_images(w, noise)
