"""The classifiers' eval-mode batch norm, with its ReLU6 and its residual add,
as one CUDA pass, with the plain PyTorch chain beside it.

:func:`frozen_bn_plain` is the chain ``models.classifiers.FrozenBatchNorm2d``
runs wherever the kernel does not: ``(y - mean) * scale + bias`` per channel
as three broadcast kernels, then ``hardtanh(0, 6)`` and ``residual + out``
where asked. :func:`frozen_bn` computes the same value, bit for bit, in one
kernel (``csrc/frozen_bn.cu``) that reads ``y`` (and the residual) once and
writes a new tensor once, in float32 or bfloat16, NCHW or channels-last. It
records no autograd graph: the module calls it only where autograd records
nothing. :func:`takes_kernel` says whether a tensor lies where the kernel
runs (a CUDA device); there the kernel raises on what it does not take.
Nothing falls back from the kernel to the plain chain.

``LAUNCHES["frozen_bn"]`` (``ops.LAUNCHES``) counts its launches.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from stylex_tpu_torch import csrc
from stylex_tpu_torch.ops.blur import LAUNCHES

__all__ = ["frozen_bn", "frozen_bn_plain", "launch", "takes_kernel"]

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def frozen_bn_plain(y: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                    relu6: bool = False) -> torch.Tensor:
    """``(y - mean) * scale + bias`` per channel of an NCHW ``y``, then
    ``hardtanh(0, 6)`` if ``relu6``, then ``residual + out`` if a residual
    is given: each a PyTorch op of its own."""
    out = (y - mean[:, None, None]) * scale[:, None, None] + bias[:, None, None]
    if relu6:
        out = F.hardtanh(out, 0.0, 6.0)
    return out if residual is None else residual + out


def takes_kernel(y: torch.Tensor) -> bool:
    """Whether ``y`` lies where the kernel runs: on a CUDA device."""
    return y.device.type == "cuda"


def launch(fn: Callable, y: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor, residual: Optional[torch.Tensor], relu6: bool, device: int,
           stream) -> torch.Tensor:
    """Launch C function ``fn`` (``frozen_bn_f32`` or ``frozen_bn_bf16``)
    over ``y`` on ``stream``: the output, in ``y``'s layout where that is
    channels-last, else NCHW (``y`` and the residual copied to it where they
    are not dense)."""
    nhwc = y.is_contiguous(memory_format=torch.channels_last) and not y.is_contiguous()
    layout = torch.channels_last if nhwc else torch.contiguous_format
    y = y.contiguous(memory_format=layout)
    residual = None if residual is None else residual.contiguous(memory_format=layout)
    mean, scale, bias = (t.contiguous() for t in (mean, scale, bias))
    out = torch.empty_like(y, memory_format=layout)
    if out.numel() == 0:
        return out
    n, c, h, w = y.shape
    ptrs = [y.data_ptr(), out.data_ptr()] + ([] if residual is None else [residual.data_ptr()])
    err = fn(y.data_ptr(), None if residual is None else residual.data_ptr(), out.data_ptr(),
             mean.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.numel(), c,
             1 if nhwc else h * w, int(relu6), int(all(p % 16 == 0 for p in ptrs)), device,
             stream)
    if err != 0:
        raise RuntimeError(f"frozen_bn: kernel launch failed with CUDA error {err}")
    return out


@functools.lru_cache(maxsize=None)
def _function(dtype: torch.dtype) -> Callable:
    """The C function for ``dtype``, its library built and loaded at first use."""
    return getattr(csrc.load("frozen_bn"), f"frozen_bn_{_SUFFIX[dtype]}")


def frozen_bn(y: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              residual: Optional[torch.Tensor] = None, relu6: bool = False) -> torch.Tensor:
    """:func:`frozen_bn_plain`'s value in one kernel launch: ``y`` a 4-d
    float32 or bfloat16 CUDA tensor, ``residual`` of its shape, ``mean``,
    ``scale`` and ``bias`` of its channels, all of its dtype on its device.
    A new tensor; the inputs are left as they are. Raises on other
    operands."""
    others = [mean, scale, bias] + ([] if residual is None else [residual])
    if not takes_kernel(y) or y.dtype not in _SUFFIX or y.dim() != 4:
        raise TypeError(f"frozen_bn: the kernel takes a 4-d float32 or bfloat16 CUDA tensor, "
                        f"got {y.dim()}-d {y.dtype} on {y.device}")
    if any(t.device != y.device or t.dtype != y.dtype for t in others):
        raise TypeError("frozen_bn: mean, scale, bias and the residual need y's dtype and "
                        "device")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"frozen_bn: residual {tuple(residual.shape)} is not y's "
                         f"{tuple(y.shape)}")
    if not (mean.numel() == scale.numel() == bias.numel() == y.shape[1]):
        raise ValueError("frozen_bn: mean, scale and bias need one entry per channel")
    index = y.get_device()
    out = launch(_function(y.dtype), y, mean, scale, bias, residual, relu6, index,
                 torch._C._cuda_getCurrentRawStream(index))
    LAUNCHES["frozen_bn"] += int(out.numel() > 0)
    return out
