"""Model and training configuration.

``ModelConfig`` has the same fields, defaults and ``.config.json`` layout
as the JAX package's, so a model directory written by either package is
read by the other. ``TrainConfig`` holds the JAX package's training fields
and defaults that the port reads.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple


class Arch(str, Enum):
    """Architecture variant.

    OLD: raw classifier logits concatenated into w; unconditional D.
    NEW: softmax probabilities concatenated after the mapping net;
         projection (conditional) D.
    """

    OLD = "old"
    NEW = "new"


@dataclass
class ModelConfig:
    """Everything needed to (re)build the networks; the superset of the
    reference's persisted ``.config.json``."""

    image_size: int = 64
    network_capacity: int = 16
    fmap_max: int = 512
    latent_dim: int = 514  # 512 encoder dims + num_classes condition dims
    style_depth: int = 8
    lr_mlp: float = 0.1
    transparent: bool = False
    attn_layers: Tuple[int, ...] = ()
    no_const: bool = False
    num_classes: int = 2
    encoder_dim: int = 512
    arch: Arch = Arch.OLD
    encoder_class: Optional[str] = None  # debug encoder registry name
    fq_layers: Tuple[int, ...] = ()  # D feature-quantization layers
    fq_dict_size: int = 256
    remat: bool = False  # recompute each G block's forward in the backward pass

    @property
    def mapping_dim(self) -> int:
        """Mapping-net width: full latent for OLD, latent - num_classes for NEW."""
        return self.latent_dim if self.arch == Arch.OLD else self.latent_dim - self.num_classes

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["arch"] = self.arch.value
        d["attn_layers"] = list(self.attn_layers)
        d["fq_layers"] = list(self.fq_layers)
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        d = json.loads(s)
        d["arch"] = Arch(d.get("arch", "old"))
        d["attn_layers"] = tuple(d.get("attn_layers", ()))
        d["fq_layers"] = tuple(d.get("fq_layers", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class TrainConfig:
    """Training hyperparameters: the JAX package's ``TrainConfig`` fields
    and defaults that the port's training reads."""

    batch_size: int = 4
    gradient_accumulate_every: int = 8
    lr: float = 2e-4
    ttur_mult: float = 1.5
    encoder_lr: Optional[float] = None  # NEW arch: 1e-5 when None
    mixed_prob: float = 0.9
    kl_scaling: float = 1.0
    rec_scaling: float = 1.0
    alternating_training: bool = True
    kl_rec_during_disc: bool = False
    sample_from_encoder: bool = True
    dual_contrast_loss: bool = False
    rel_disc_loss: bool = False
    cl_reg: bool = False  # contrastive D regularisation on two views of the reals
    top_k_training: bool = False
    generator_top_k_gamma: float = 0.99
    generator_top_k_frac: float = 0.5
    aug_prob: Optional[float] = None  # set from the dataset size when None
    num_workers: Optional[int] = None
    aug_types: Tuple[str, ...] = ("translation", "cutout")
    dataset_aug_prob: float = 0.0
    no_pl_reg: bool = False
    gp_every: int = 4
    pl_every: int = 32
    pl_start_step: int = 5000
    ema_beta: float = 0.995
    ema_every: int = 10
    ema_start_step: int = 20_000
    ema_reset_every: int = 1000
    ema_reset_until: int = 25_000
    save_every: int = 500
    evaluate_every: int = 50
    calculate_fid_every: Optional[int] = None  # steps between FID evaluations; None: never
    calculate_fid_num_images: int = 12800
    trunc_psi: float = 0.75
    num_image_tiles: int = 8
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' | 'float64' (a CPU witness)
    # Host-loop pipelining: the number of steps whose metrics may stay in
    # flight (on the device, copying to the host) before the host blocks to
    # read, log and NaN-check them. 0 reads every step's metrics at once, as
    # the reference does. NaN detection lags by at most this many steps
    # (plus the block's own, with steps_per_dispatch > 1); every save
    # drains first, so a NaN state is never saved.
    metrics_lag: int = 8
    # Steps issued back to back as one block, with no host read between
    # them. 1 is the reference's one step per host iteration. Randomness and
    # periodic work are exact: the block's draws are taken in sequential
    # order, and a save / evaluate / FID step always ends its block.
    steps_per_dispatch: int = 1
    # Checkpoints are written by a background thread from a device-side
    # snapshot, so the loop keeps stepping; loads, the next save, flush()
    # and close() join the writer. False: the reference's blocking save.
    async_save: bool = True
    fused_microbatches: bool = True  # False: the scan step, one micro-batch at a time
    num_train_steps: int = 150_000  # a block never runs past it
    # data-parallel ranks (stylex_tpu_torch.parallel); None: the group the
    # trainer runs in (one process outside a launched worker)
    num_devices: Optional[int] = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["aug_types"] = list(self.aug_types)
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        """Read either package's ``TrainConfig`` JSON; fields the port does
        not have (``seed``) are dropped."""
        d = json.loads(s)
        d["aug_types"] = tuple(d.get("aug_types", ("translation", "cutout")))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
