"""Vector quantization with an EMA codebook: the D/E trunk's optional
feature-quantization layers (``fq_layers``).

The same semantics as the JAX package's ``ops/vq.py``: nearest code by
squared distance, a straight-through estimator (gradients pass to the
input unchanged), the commitment loss ``mean((sg(q) - x)^2)``, and an EMA
update of the cluster sizes and code sums from which the codebook is
re-estimated (Laplace-smoothed sizes). The codebook takes no gradient.
With a ``reduce`` (a sum over the ranks of a data-parallel group) the
update sums the statistics over the ranks first.

:func:`vector_quantize` is a function of an explicit :class:`VQState`;
:class:`VectorQuantize` keeps that state in buffers, so it is saved and
loaded with the model, and updates them only when asked.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["VQState", "vector_quantize", "VectorQuantize"]

Reduce = Callable[[torch.Tensor], torch.Tensor]


class VQState(NamedTuple):
    codebook: torch.Tensor  # (n_codes, dim)
    cluster_size: torch.Tensor  # (n_codes,)
    embed_avg: torch.Tensor  # (n_codes, dim)


def vector_quantize(state: VQState, x: torch.Tensor, *, decay: float = 0.8,
                    commitment: float = 1.0, eps: float = 1e-5, update: bool = True,
                    reduce: Optional[Reduce] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQState]:
    """Quantize ``x`` (..., dim) against the codebook.

    Returns (quantized with the straight-through estimator, code indices
    (...), commitment loss, the state after the EMA update, or ``state``
    itself when ``update`` is False). ``reduce`` sums the update's cluster
    sizes and code sums over the ranks that each hold a slice of the batch,
    so the codebooks see the whole batch.
    """
    flat = x.reshape(-1, x.shape[-1])
    book = state.codebook.to(flat.dtype)
    dist = (flat.square().sum(dim=1, keepdim=True) - 2.0 * (flat @ book.t())
            + book.square().sum(dim=1)[None, :])
    idx = dist.argmin(dim=1)
    quantized = book[idx].reshape(x.shape)
    loss = commitment * (quantized.detach() - x).square().mean()
    quantized = x + (quantized - x).detach()
    if update:
        with torch.no_grad():  # in the state's dtype
            flat = flat.to(state.embed_avg.dtype)
            onehot = F.one_hot(idx, book.shape[0]).to(flat.dtype)
            counts, sums = onehot.sum(dim=0), onehot.t() @ flat
            if reduce is not None:  # one reduction of both statistics
                both = reduce(torch.cat([counts[:, None], sums], dim=1))
                counts, sums = both[:, 0], both[:, 1:]
            cluster_size = state.cluster_size * decay + (1.0 - decay) * counts
            embed_avg = state.embed_avg * decay + (1.0 - decay) * sums
            n = cluster_size.sum()
            smoothed = (cluster_size + eps) / (n + book.shape[0] * eps) * n
            state = VQState(embed_avg / smoothed[:, None], cluster_size, embed_avg)
    return quantized, idx.reshape(x.shape[:-1]), loss, state


class VectorQuantize(nn.Module):
    """Quantizes the channels of an NCHW map; the codebook, the cluster
    sizes and the code sums are buffers."""

    def __init__(self, dim: int, n_codes: int, decay: float = 0.8, commitment: float = 1.0,
                 eps: float = 1e-5):
        super().__init__()
        self.decay, self.commitment, self.eps = decay, commitment, eps
        self.register_buffer("codebook", torch.empty(n_codes, dim))
        self.register_buffer("cluster_size", torch.zeros(n_codes))
        self.register_buffer("embed_avg", torch.empty(n_codes, dim))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.codebook.normal_(0.0, 1.0, generator=generator)
        self.cluster_size.zero_()
        self.embed_avg.copy_(self.codebook)

    def forward(self, x: torch.Tensor, update: bool = False, reduce: Optional[Reduce] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, C, H, W) -> (quantized map, contiguous NCHW; commitment
        loss). ``update`` applies the EMA update to the buffers, its
        statistics summed by ``reduce`` (:func:`vector_quantize`)."""
        state = VQState(self.codebook, self.cluster_size, self.embed_avg)
        q, _, loss, new = vector_quantize(state, x.permute(0, 2, 3, 1), decay=self.decay,
                                          commitment=self.commitment, eps=self.eps,
                                          update=update, reduce=reduce)
        if update:
            with torch.no_grad():
                for buf, value in zip(state, new):
                    buf.copy_(value)
        return q.permute(0, 3, 1, 2).contiguous(), loss
