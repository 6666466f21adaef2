"""Training state: the networks, their optimizers, the EMA copies and the
regulariser statistics.

The live nets ``encoder``, ``S``, ``G``, ``D`` and the EMA copies ``SE``,
``GE`` live in one :class:`~stylex_tpu_torch.models.stylex.StylEx`, so a
checkpoint is its state dict under the reference's keys. The step is a
Python int; ``pl_mean`` is a 0-d float32 tensor on the model's device
(``-1`` means not yet set) so that the step never waits on the device to
update it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from stylex_tpu_torch.config import Arch, ModelConfig, TrainConfig
from stylex_tpu_torch.models.stylex import StylEx

__all__ = ["TrainState", "create_train_state", "make_optimizers", "g_parameters"]

GSUB = ("encoder", "S", "G")


def g_parameters(model: StylEx) -> List[torch.nn.Parameter]:
    """The parameters the G phase trains, in the order the step takes
    their gradients: encoder, then S, then G."""
    return [p for name in GSUB for p in getattr(model, name).parameters()]


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.9), eps=1e-8)


def make_optimizers(model: StylEx, model_cfg: ModelConfig, train_cfg: TrainConfig):
    """Adam(0.5, 0.9) for G and D; D's learning rate is ``lr * ttur_mult``.
    The NEW arch trains the encoder in a param group of its own
    (``encoder_lr``, 1e-5 when unset)."""
    lr = train_cfg.lr
    if model_cfg.arch == Arch.NEW:
        enc_lr = train_cfg.encoder_lr if train_cfg.encoder_lr is not None else 1e-5
        g_opt = _adam([
            {"params": list(model.encoder.parameters()), "lr": enc_lr},
            {"params": list(model.S.parameters()) + list(model.G.parameters())},
        ], lr)
    else:
        g_opt = _adam(g_parameters(model), lr)
    d_opt = _adam(model.D.parameters(), lr * train_cfg.ttur_mult)
    return g_opt, d_opt


@dataclass
class TrainState:
    model: StylEx
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int
    pl_mean: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.model.G.initial_conv.weight.device


def create_train_state(model: StylEx, model_cfg: ModelConfig,
                       train_cfg: TrainConfig) -> TrainState:
    """Optimizers over ``model``'s live nets, step 0, ``pl_mean`` unset.
    The EMA copies are frozen: they take no gradients."""
    for name in ("SE", "GE"):
        getattr(model, name).requires_grad_(False)
    g_opt, d_opt = make_optimizers(model, model_cfg, train_cfg)
    device = model.G.initial_conv.weight.device
    return TrainState(model, g_opt, d_opt, 0, torch.tensor(-1.0, device=device))
