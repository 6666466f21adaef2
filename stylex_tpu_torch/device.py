"""Device resolution, the float32 precision policy, and host copies.

Entry points run on the GPU unless the caller asks for the CPU: with no GPU
and no explicit ``device="cpu"`` they raise instead of carrying on slowly on
the host.

The float32 path computes in full float32, as the JAX package and the
reference notebook do. PyTorch's default lets cuDNN run float32
convolutions in TF32 (about three decimal digits), so
:func:`set_float32_precision` turns TF32 off for both cuDNN and matmuls.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

__all__ = ["resolve_device", "set_float32_precision", "resolve_dtype", "to_host_async",
           "map_tensors"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU; an explicit device is taken as given.

    Raises ``RuntimeError`` when the GPU is asked for (explicitly or by
    default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the host"
        )
    return dev


def resolve_dtype(dtype: Union[None, str, torch.dtype]) -> torch.dtype:
    """``None``/``"float32"`` -> float32, ``"bfloat16"`` -> bfloat16."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(str(dtype))
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype!r}")
    return out


def set_float32_precision() -> None:
    """Compute float32 convolutions and matmuls in full float32 (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``. For a CUDA tensor: a pinned buffer filled by a
    non-blocking copy on the current stream, valid once the device has
    passed the copy (an event recorded after it, or a synchronise); the
    host does not wait. A CPU tensor is returned as it is."""
    if not t.is_cuda:
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


def map_tensors(tree, fn: Callable[[torch.Tensor], Any]):
    """``tree`` with ``fn`` applied to every tensor in its dicts, lists and
    tuples (named ones too); other leaves stay."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [map_tensors(v, fn) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)
    return tree
