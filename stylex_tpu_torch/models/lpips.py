"""LPIPS perceptual distance with an AlexNet backbone, NCHW.

The recipe of Zhang et al. (CVPR 2018), as the JAX package computes it:

    d(x, y) = sum_l mean_hw sum_c w_l,c * (norm(f_l(x)) - norm(f_l(y)))^2

over the five AlexNet relu taps, ``norm`` a unit normalisation over
channels and ``w_l`` non-negative per-channel weights. Parameters are a
plain dict ``{'conv{i}': {'weight': OIHW, 'bias'}, 'lin{i}': (C,)}``, frozen.

:func:`init_lpips_params` gives a seeded random backbone with uniform taps,
the default when no weights file is given (nothing is downloaded);
:func:`load_lpips_params` reads a local ``lpips.LPIPS(net='alex')``
state dict. The JAX package's parameter tree comes in through
:func:`stylex_tpu_torch.models.convert.lpips_params_from_jax`.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "LPIPS_CFG",
    "lpips_distance",
    "init_lpips_params",
    "convert_lpips_state_dict",
    "load_lpips_params",
    "lpips_params_to",
]

# AlexNet features: (out_ch, kernel, stride, pad), max pool after taps 0 and 1
LPIPS_CFG = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]

# the lpips package's input scaling of [-1, 1] images
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

Params = Dict[str, Any]


def _alexnet_features(params: Params, x: torch.Tensor):
    taps = []
    for i, (_, _, stride, pad) in enumerate(LPIPS_CFG):
        conv = params[f"conv{i}"]
        x = F.relu(F.conv2d(x, conv["weight"].to(x.dtype), conv["bias"].to(x.dtype),
                            stride=stride, padding=pad))
        taps.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, 3, 2)
    return taps


def lpips_distance(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B,) perceptual distances between (B, 3, H, W) batches in [-1, 1].

    Images under 32 pixels are first upsampled bilinearly to 32, so that
    the stride-4 stem leaves every tap at least one pixel.
    """
    dtype = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(dtype), y.to(dtype)
    h, w = x.shape[-2:]
    if h < 32 or w < 32:
        size = (max(h, 32), max(w, 32))
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
        y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
    shift = torch.as_tensor(_SHIFT, device=x.device).to(dtype)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device).to(dtype)[:, None, None]
    b = x.shape[0]
    # one backbone pass over [x; y]
    feats = _alexnet_features(params, torch.cat([(x - shift) / scale, (y - shift) / scale]))
    total = 0.0
    for i, t in enumerate(feats):
        tn = t / torch.sqrt(t.square().sum(dim=1, keepdim=True) + 1e-10)
        diff = (tn[:b] - tn[b:]).square()
        lin = params[f"lin{i}"].to(dtype)[:, None, None]
        total = total + (diff * lin).sum(dim=1).mean(dim=(1, 2))
    return total


def init_lpips_params(seed: int = 7, device=None) -> Params:
    """Seeded random backbone (kaiming-normal convs, zero biases) with
    uniform taps 1/C."""
    generator = torch.Generator().manual_seed(seed)
    params: Params = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(LPIPS_CFG):
        std = math.sqrt(2.0 / (in_ch * k * k))
        params[f"conv{i}"] = {
            "weight": torch.randn(out_ch, in_ch, k, k, generator=generator) * std,
            "bias": torch.zeros(out_ch),
        }
        params[f"lin{i}"] = torch.full((out_ch,), 1.0 / out_ch)
        in_ch = out_ch
    return lpips_params_to(params, device or "cpu")


def lpips_params_to(params: Params, device, dtype=torch.float32) -> Params:
    return {k: ({kk: vv.to(device, dtype) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(device, dtype)) for k, v in params.items()}


def convert_lpips_state_dict(sd: Dict[str, torch.Tensor]) -> Params:
    """A torch ``lpips.LPIPS(net='alex')`` state dict (``net.slice{n}.<i>``
    or ``net.features.<i>`` convs, ``lin{i}.model.1.weight`` taps) -> params.
    Convs are matched by shape in key order; missing taps are uniform."""
    conv_keys = [k for k in sd if k.endswith(".weight") and sd[k].dim() == 4 and "lin" not in k]
    conv_keys.sort(key=lambda k: [int(s) for s in k.split(".") if s.isdigit()])
    params: Params = {}
    in_ch, ki = 3, 0
    for i, (out_ch, k, _, _) in enumerate(LPIPS_CFG):
        while ki < len(conv_keys) and tuple(sd[conv_keys[ki]].shape) != (out_ch, in_ch, k, k):
            ki += 1
        if ki >= len(conv_keys):
            raise ValueError(
                f"LPIPS state dict has no conv matching ({out_ch},{in_ch},{k},{k}) for tap {i}: "
                "pass a full lpips.LPIPS(net='alex').state_dict(), AlexNet backbone included. "
                f"Keys seen: {sorted(sd)[:6]}..."
            )
        key = conv_keys[ki]
        params[f"conv{i}"] = {"weight": sd[key].float(),
                              "bias": sd[key[: -len(".weight")] + ".bias"].float()}
        lin = sd.get(f"lin{i}.model.1.weight")
        params[f"lin{i}"] = (lin.float().reshape(-1) if lin is not None
                             else torch.full((out_ch,), 1.0 / out_ch))
        in_ch, ki = out_ch, ki + 1
    return params


def load_lpips_params(path: str, device=None) -> Params:
    """LPIPS-alex weights from an ingested ``.msgpack`` tree (the JAX
    package's layout, as ``stylex_tpu_torch.ingest lpips`` writes it) or a
    local torch ``lpips.LPIPS(net='alex')`` state dict; raises if the file
    is missing or holds no AlexNet backbone."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"LPIPS weights not found: {path}")
    if str(path).endswith((".msgpack", ".mp")):
        from stylex_tpu_torch.models.convert import lpips_params_from_jax
        from stylex_tpu_torch.utils import flax_msgpack

        tree = flax_msgpack.load(path)
        if not isinstance(tree, dict) or not any(str(k).startswith("conv") for k in tree):
            raise ValueError(f"{path} is not an ingested LPIPS tree")
        return lpips_params_to(lpips_params_from_jax(tree), device or "cpu")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return lpips_params_to(convert_lpips_state_dict(sd), device or "cpu")
