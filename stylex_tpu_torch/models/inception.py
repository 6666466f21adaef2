"""InceptionV3 in its FID variant: the 2048-d pool3 feature extractor.

The published architecture (Szegedy et al., 2015) as pytorch_fid runs it
for FID, in NCHW, with torchvision's module and state-dict key names
(``Mixed_5b.branch1x1.conv.weight``...), so a torchvision or pytorch_fid
``inception_v3`` state dict loads directly once its classifier keys are
dropped (:func:`convert_inception_state_dict`). Against the classification
network:

* every conv is bias-free and followed by eval-mode batch norm with eps
  1e-3, then ReLU;
* the branch-pool average pools leave the padding out of the count
  (``count_include_pad=False``);
* Mixed_7c's pool branch takes a 3x3 max pool;
* the output is the mean over H and W of Mixed_7c: (B, 2048).

:func:`pool3_features_fn` wraps a network as a feature function of
:mod:`stylex_tpu_torch.eval.fid`: images in [0, 1] resized to 299 as
``jax.image.resize`` does, scaled to [-1, 1]. :func:`default_pool3_features`
reads the weights named by ``STYLEX_TPU_INCEPTION``; with it unset FID falls
back to the seeded AlexNet. Without real weights, :func:`build_inception`
gives the network a seeded random init.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stylex_tpu_torch.device import resolve_device
from stylex_tpu_torch.eval.fid import resize_bilinear

__all__ = [
    "InceptionV3FID",
    "build_inception",
    "pool3_features_fn",
    "load_inception_variables",
    "default_pool3_features",
    "convert_inception_state_dict",
]

ENV = "STYLEX_TPU_INCEPTION"
Pair = Union[int, Tuple[int, int]]


def _avg_pool_3x3_exc(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class BasicConv2d(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: Pair, stride: int = 1, padding: Pair = 0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)

    def forward(self, x):
        x = self.conv(x)
        x = F.batch_norm(x, self.bn.running_mean, self.bn.running_var, self.bn.weight,
                         self.bn.bias, training=False, eps=self.bn.eps)
        return F.relu(x)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_exc(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_exc(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = (F.max_pool2d(x, 3, stride=1, padding=1) if self.use_max_pool
                  else _avg_pool_3x3_exc(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3FID(nn.Module):
    """The trunk up to the 2048-d pool3 features, on (B, 3, H, W) images in
    [-1, 1] (H, W >= 75)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


@torch.no_grad()
def build_inception(seed: int = 0, state_dict=None, device=None) -> InceptionV3FID:
    """An eval-mode, frozen network on ``device`` (the GPU unless ``'cpu'``):
    with ``state_dict`` (torchvision layout or converted) its weights, else
    a seeded random init (convs normal with std sqrt(2 / fan_in), batch norm
    at identity statistics)."""
    net = InceptionV3FID()
    if state_dict is not None:
        net.load_state_dict(convert_inception_state_dict(state_dict))
    else:
        gen = torch.Generator().manual_seed(seed)
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
    return net.to(resolve_device(device)).eval().requires_grad_(False)


def pool3_features_fn(net: InceptionV3FID, resize_to: int = 299):
    """(B, 3, H, W) images in [0, 1] -> (B, 2048) pool3 features on the
    network's device: resized to ``resize_to`` as ``jax.image.resize`` does
    (bilinear, antialiased when shrinking), then scaled to [-1, 1]."""
    device = next(net.parameters()).device

    @torch.no_grad()
    def features(images: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(images.to(device, torch.float32), resize_to)
        return net(x * 2.0 - 1.0)

    return features


def load_inception_variables(path: str) -> Dict[str, torch.Tensor]:
    """The state dict for :class:`InceptionV3FID` of an ingested ``.msgpack``
    tree (the JAX package's flax variables, as ``stylex_tpu_torch.ingest
    inception`` writes them) or of a torchvision or pytorch_fid
    ``inception_v3`` weights file. Raises when the file is missing or holds
    no such weights."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Inception weights not found: {path}")
    if str(path).endswith((".msgpack", ".mp")):
        from stylex_tpu_torch.models.convert import inception_state_dict_from_jax
        from stylex_tpu_torch.utils import flax_msgpack

        tree = flax_msgpack.load(path)
        if not isinstance(tree, dict) or "params" not in tree or "batch_stats" not in tree:
            raise ValueError(f"{path} is not an ingested Inception tree")
        return inception_state_dict_from_jax(tree)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} does not hold a state dict")
    return convert_inception_state_dict(sd)


def default_pool3_features(device=None):
    """InceptionV3 pool3 features with the weights named by
    ``STYLEX_TPU_INCEPTION``, on ``device``. None when the variable is
    unset; a set but missing or malformed path raises, so requested real
    weights never silently give way to the fallback."""
    path = os.environ.get(ENV)
    if not path:
        return None
    return pool3_features_fn(build_inception(state_dict=load_inception_variables(path),
                                             device=device))


def convert_inception_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision / pytorch_fid ``inception_v3`` state dict (tensors or
    numpy arrays) -> :class:`InceptionV3FID`'s: the classifier keys
    (``fc``, ``AuxLogits``) dropped, float32 weights and statistics, and a
    batch-norm ``num_batches_tracked`` of 0 where the file has none."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        if key.split(".")[0] in ("fc", "AuxLogits"):
            continue
        t = val.detach().cpu() if torch.is_tensor(val) else torch.from_numpy(np.asarray(val))
        out[key] = t if key.endswith("num_batches_tracked") else t.float()
        if key.endswith(".bn.running_var"):
            out.setdefault(key[: -len("running_var")] + "num_batches_tracked",
                           torch.tensor(0, dtype=torch.int64))
    return out
