"""Model configuration and its ``.config.json`` round trip.

The same fields, defaults and JSON layout as the JAX package's
``ModelConfig``, so a model directory written by either package is read by
the other.
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
    # a training option of the JAX package; kept so .config.json files
    # round-trip unchanged
    remat: bool = False

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
