"""The StylEx bundle: encoder + mapping + generator + discriminator.

One ``nn.Module`` whose submodules and state-dict keys are the reference
checkpoint's: ``encoder``, ``S``, ``G``, ``D`` and the EMA copies ``SE`` and
``GE``. A reference ``{'StylEx': state_dict}`` checkpoint therefore loads
with ``load_state_dict`` (see :mod:`stylex_tpu_torch.models.convert`).

:func:`make_w` / :func:`prior_w` cover both architectures:

* OLD: w = [E(x); classifier logits], mapping width = latent_dim;
* NEW: w = [E(x); softmax(logits)], and prior samples [S(z); probabilities]
  with mapping width latent_dim - num_classes.

The encoder is D's trunk in 'encoder' mode (attention and quantize layers
included), or with ``encoder_class`` one of the debug encoders.

The ``sweep_*`` methods and ``block_sizes`` / ``block_resolutions`` are what
the AttFind sweep (:mod:`stylex_tpu_torch.attfind.extraction`) asks of a
model; Google's generator offers the same.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from stylex_tpu_torch.config import Arch, ModelConfig
from stylex_tpu_torch.device import resolve_device
from stylex_tpu_torch.models.debug_encoders import encoder_registry
from stylex_tpu_torch.models.discriminator import DiscriminatorE
from stylex_tpu_torch.models.generator import Conv2DMod, Generator, InitialBlockConv
from stylex_tpu_torch.models.layers import Conv2d, EqualLinear, Linear
from stylex_tpu_torch.models.mapping import StyleVectorizer
from stylex_tpu_torch.ops.latents import expand_styles
from stylex_tpu_torch.ops.vq import VectorQuantize

__all__ = ["StylEx", "build_stylex", "make_w", "prior_w", "ema_update"]

_SEEDED = (Linear, Conv2d, EqualLinear, Conv2DMod, Generator, InitialBlockConv, VectorQuantize)


class StylEx(nn.Module):
    has_discriminator = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

        def trunk(mode):
            # the encoder shares D's trunk config, quantize layers included
            return DiscriminatorE(
                cfg.image_size, cfg.network_capacity, cfg.attn_layers, cfg.transparent,
                mode=mode, encoder_dim=cfg.encoder_dim, num_classes=cfg.num_classes,
                fmap_max=cfg.fmap_max, fq_layers=cfg.fq_layers, fq_dict_size=cfg.fq_dict_size,
            )

        def generator():
            return Generator(cfg.image_size, cfg.latent_dim, cfg.network_capacity,
                             cfg.transparent, cfg.attn_layers, cfg.no_const, cfg.fmap_max,
                             remat=cfg.remat)

        if cfg.encoder_class is None:
            self.encoder = trunk("encoder")
        else:
            self.encoder = encoder_registry[cfg.encoder_class](
                cfg.image_size, 4 if cfg.transparent else 3)
        self.S = StyleVectorizer(cfg.mapping_dim, cfg.style_depth, lr_mul=cfg.lr_mlp)
        self.G = generator()
        self.D = trunk("cond_disc" if cfg.arch == Arch.NEW else "disc")
        self.SE = StyleVectorizer(cfg.mapping_dim, cfg.style_depth, lr_mul=cfg.lr_mlp)
        self.GE = generator()

    @property
    def num_layers(self) -> int:
        return self.G.num_layers

    @property
    def total_style_coords(self) -> int:
        return self.G.total_style_coords

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)

    def map_z(self, z: torch.Tensor, ema: bool = False) -> torch.Tensor:
        return (self.SE if ema else self.S)(z)

    def generate(self, w_styles, noise, style_delta=None, ema: bool = False,
                 start_block: int = 0, initial_state=None, capture_states: bool = False):
        return (self.GE if ema else self.G)(
            w_styles, noise, style_delta, start_block, initial_state, capture_states
        )

    def discriminate(self, images: torch.Tensor,
                     probabilities: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.D(images, probabilities)

    @property
    def block_sizes(self) -> List[int]:
        """StyleSpace coordinates per generator block."""
        return [i + o for i, o in self.G.block_dims]

    @property
    def block_resolutions(self) -> List[int]:
        return [4 * 2 ** k for k in range(len(self.G.block_dims))]

    def sweep_phase1(self, images, classify, noise, capture: bool):
        """AttFind's phase 1 of (B, 3, S, S) images in [0, 1]: encode -> w
        -> generate (+ coords, + block states) -> D score -> base logits.
        Returns ``(w, coords, d, base_logits, states, None)``: the inputs
        are the records' original images."""
        w = make_w(self.cfg, self.encode(images), classify(images))
        out = self.generate(expand_styles(w, self.num_layers), noise, capture_states=capture)
        gen, coords = out[0], out[1]
        base_logits = classify(gen)
        if self.cfg.arch == Arch.NEW:
            d = self.discriminate(gen, torch.softmax(base_logits, dim=-1))
        else:
            d = self.discriminate(gen)
        return w, coords, d, base_logits, (out[2] if capture else None), None

    def sweep_states(self, w, noise):
        """Every block's entry state of one generator forward of ``w``."""
        return self.generate(expand_styles(w, self.num_layers), noise, capture_states=True)[2]

    def sweep_images(self, w, noise, style_delta, start_block: int = 0, initial_state=None):
        """The images the classifier scores for perturbed styles, resumed at
        ``start_block`` from ``initial_state``."""
        return self.generate(expand_styles(w, self.num_layers), noise, style_delta=style_delta,
                             start_block=start_block, initial_state=initial_state)[0]


def build_stylex(cfg: ModelConfig, seed: int = 0, device=None) -> StylEx:
    """A StylEx with the reference's init drawn from ``seed``; the EMA
    copies start equal to the live nets. Placed on ``device`` (the GPU
    unless ``'cpu'``)."""
    device = resolve_device(device)
    model = StylEx(cfg)
    generator = torch.Generator().manual_seed(seed)
    for m in (model.encoder, model.S, model.G, model.D):
        for sub in m.modules():
            if isinstance(sub, _SEEDED):
                sub.reset_parameters(generator)
    model.SE.load_state_dict(model.S.state_dict())
    model.GE.load_state_dict(model.G.state_dict())
    return model.to(device).eval()


def make_w(cfg: ModelConfig, encoder_output: torch.Tensor,
           classifier_logits: torch.Tensor) -> torch.Tensor:
    """Encoder-path w: the encoding concatenated with the conditioning."""
    cond = torch.softmax(classifier_logits, dim=-1) if cfg.arch == Arch.NEW else classifier_logits
    return torch.cat([encoder_output, cond], dim=-1)


def prior_w(cfg: ModelConfig, s_out: torch.Tensor,
            probabilities: Optional[torch.Tensor]) -> torch.Tensor:
    """Prior-path w: OLD maps the full latent through S; NEW appends the
    probabilities after S."""
    if cfg.arch == Arch.NEW:
        return torch.cat([s_out, probabilities], dim=-1)
    return s_out


@torch.no_grad()
def ema_update(ema: nn.Module, live: nn.Module, beta: float = 0.995) -> None:
    """``ema = ema * beta + (1 - beta) * live``, parameter by parameter. The
    JAX package returns a new tree; this updates ``ema`` in place."""
    for e, n in zip(ema.parameters(), live.parameters(), strict=True):
        e.copy_(e * beta + (1.0 - beta) * n)
