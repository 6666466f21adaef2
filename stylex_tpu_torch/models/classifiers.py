"""Classifiers: ResNet-18 and MobileNetV2 with torchvision's state-dict
keys, written out by hand (torchvision is not a dependency).

In eval mode, the only mode of the frozen nets that AttFind and StylEx
training use, batch norm normalises with its running statistics (eps 1e-5)
and dropout is off. In train mode (classifier pretraining) they follow the
JAX package's flax modules: batch norm as ``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)``, and MobileNetV2's head dropout draws from the
``torch.Generator`` passed to ``forward``. :class:`ClassifierBundle` keeps
the reference adapters' preprocessing, asymmetry included:

* ResNet resizes images bilinearly to 224 before classifying;
* MobileNet resizes them with nearest to ``image_size`` and skips the
  resize when the size already matches;
* both then apply ImageNet normalisation.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stylex_tpu_torch.ops import frozen_bn as _bn_kernel
from stylex_tpu_torch.utils import tracing

__all__ = [
    "ResNet18",
    "MobileNetV2",
    "ClassifierBundle",
    "build_classifier",
    "read_classifier_weights",
    "imagenet_normalize",
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std per channel of an NCHW batch in [0, 1]."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).to(x.dtype)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=x.device).to(x.dtype)[:, None, None]
    return (x - mean) / std


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """Batch norm ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, then
    ReLU6 where ``act`` is ``'relu6'``, then ``residual + out`` where
    ``forward`` is given a residual (InvertedResidual's add). In eval mode
    with the running statistics. In train mode as flax's
    ``nn.BatchNorm(momentum=0.9)``: with the batch's mean and biased
    variance, computed as E[x²] - E[x]² clipped at 0, and the running
    statistics moved to ``0.9 * old + 0.1 * batch`` (torch's own batch norm
    would store the unbiased variance).

    In eval mode on a CUDA device, where autograd records nothing (grad
    mode off, or neither the input, the residual nor the parameters need a
    gradient), the layer is the hand-written pass ``ops.frozen_bn.frozen_bn``
    (float32 or bfloat16; it raises on other dtypes): the same numbers, bit
    for bit, in one read and one write. Train mode, autograd and the CPU run
    the chain as separate ops. Counters ``classifier.bn_fused`` and
    ``classifier.bn_plain`` count the layers run on each path."""

    def __init__(self, num_features: int, act: Optional[str] = None):
        super().__init__(num_features)
        if act not in (None, "relu6"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act

    def _fused(self, x: torch.Tensor, residual: Optional[torch.Tensor]) -> bool:
        """Whether this forward takes the kernel."""
        if self.training or not _bn_kernel.takes_kernel(x):
            return False
        operands = (x, self.weight, self.bias) + (() if residual is None else (residual,))
        return not (torch.is_grad_enabled() and any(t.requires_grad for t in operands))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(mean.detach(), alpha=1.0 - 0.9)
                self.running_var.mul_(0.9).add_(var.detach(), alpha=1.0 - 0.9)
        mul = torch.rsqrt(var + self.eps) * self.weight
        relu6 = self.act == "relu6"
        if self._fused(x, residual):
            tracing.count("classifier.bn_fused")
            return _bn_kernel.frozen_bn(x, mean, mul, self.bias, residual, relu6)
        tracing.count("classifier.bn_plain")
        return _bn_kernel.frozen_bn_plain(x, mean, mul, self.bias, residual, relu6)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in train mode, keep each element with
    probability ``1 - p`` (drawn from ``generator``) and scale it by
    ``1 / (1 - p)``; identity in eval mode or at ``p = 0``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train mode draws from an explicit torch.Generator")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def _conv_bn(c_in, c_out, k, stride=1, padding=0, groups=1, act=None) -> nn.Sequential:
    """conv -> bn (with its activation), keys ``.0`` and ``.1`` as
    torchvision's (whose ReLU6, ``.2``, holds no parameters)."""
    return nn.Sequential(nn.Conv2d(c_in, c_out, k, stride, padding, groups=groups, bias=False),
                         FrozenBatchNorm2d(c_out, act=act))


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(c_out)
        self.downsample = _conv_bn(c_in, c_out, 1, stride) if stride != 1 or c_in != c_out else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet18(nn.Module):
    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        c_in = 64
        for i, (feats, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(BasicBlock(c_in, feats, stride), BasicBlock(feats, feats)))
            c_in = feats
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.fc(x.mean(dim=(2, 3)))


class InvertedResidual(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = c_in * expand_ratio
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(c_in, hidden, 1, act="relu6"))
        layers += [
            _conv_bn(hidden, hidden, 3, stride, 1, groups=hidden, act="relu6"),
            nn.Conv2d(hidden, c_out, 1, bias=False),
            FrozenBatchNorm2d(c_out),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        *body, bn = self.conv  # the last batch norm adds the residual
        out = x
        for layer in body:
            out = layer(out)
        return bn(out, x if self.use_res else None)


# (expand_ratio, channels, repeats, stride): the MobileNetV2 paper's table
_MBV2_PLAN = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class MobileNetV2(nn.Module):
    def __init__(self, num_classes: int = 2, dropout_rate: float = 0.2):
        super().__init__()
        features = [_conv_bn(3, 32, 3, 2, 1, act="relu6")]
        c_in = 32
        for t, c, n, s in _MBV2_PLAN:
            for i in range(n):
                features.append(InvertedResidual(c_in, c, s if i == 0 else 1, t))
                c_in = c
        features.append(_conv_bn(c_in, 1280, 1, act="relu6"))
        self.features = nn.Sequential(*features)
        self.classifier = nn.Sequential(Dropout(dropout_rate), nn.Linear(1280, num_classes))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout mask in train mode."""
        x = self.classifier[0](self.features(x).mean(dim=(2, 3)), generator)
        return self.classifier[1](x)


class ClassifierBundle:
    """A frozen classifier with the reference adapters' preprocessing."""

    def __init__(self, kind: str, net: nn.Module, image_size: int, normalize: bool = True,
                 num_classes: int = 2):
        self.kind = kind
        self.net = net.eval()
        self.image_size = image_size
        self.normalize = normalize
        self.num_classes = num_classes

    def to(self, *args, **kwargs) -> "ClassifierBundle":
        self.net.to(*args, **kwargs)
        return self

    def classify_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1] -> (B, num_classes) logits."""
        x = images
        h, w = images.shape[-2:]
        if self.kind == "resnet":
            if (h, w) != (224, 224):
                x = F.interpolate(images, size=(224, 224), mode="bilinear", align_corners=False)
        elif (h, w) != (self.image_size, self.image_size):
            x = F.interpolate(images, size=(self.image_size, self.image_size), mode="nearest")
        if self.normalize:
            x = imagenet_normalize(x)
        return self.net(x)


@torch.no_grad()
def _torchvision_init_(net: nn.Module, generator: torch.Generator) -> None:
    """torchvision's init for these nets, drawn from ``generator``: convs
    kaiming-normal (fan-out, relu gain), batch norm 1 and 0, the MobileNetV2
    head N(0, 0.01) with zero bias, the ResNet fc torch's default uniform."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.weight[0, 0].numel() // m.groups
            m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
        elif isinstance(m, nn.Linear):
            if isinstance(net, MobileNetV2):
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()
            else:
                bound = m.in_features ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)


def read_classifier_weights(path: str, kind: str) -> Dict[str, torch.Tensor]:
    """The torchvision-layout state dict of a classifier weights file: a
    ``.msgpack`` (or ``.mp``) flax variables tree, or a torch state dict."""
    if str(path).endswith((".msgpack", ".mp")):
        from stylex_tpu_torch.models.convert import classifier_state_dict_from_jax
        from stylex_tpu_torch.utils import flax_msgpack

        tree = flax_msgpack.load(path)
        try:
            return classifier_state_dict_from_jax(tree, kind)
        except (KeyError, TypeError) as e:
            raise ValueError(f"{path} is not a {kind} classifier tree (missing {e})") from e
    return torch.load(path, map_location="cpu", weights_only=True)


def build_classifier(kind: str, image_size: int, num_classes: int = 2,
                     checkpoint_path: Optional[str] = None, seed: int = 0,
                     device=None) -> ClassifierBundle:
    """A frozen ``'resnet'`` or ``'mobilenet'`` classifier: torchvision's
    init drawn from ``seed``, or the weights in ``checkpoint_path``: an
    ingested or pretrained ``.msgpack`` tree (the JAX package's flax
    variables) or a torchvision-layout state_dict. A requested file that is
    missing or holds no such weights raises. Placed on ``device`` (the GPU
    unless ``'cpu'``)."""
    from stylex_tpu_torch.device import resolve_device

    device = resolve_device(device)
    kind = kind.lower()
    if kind not in ("resnet", "mobilenet"):
        raise ValueError(f"unknown classifier kind {kind!r}")
    net = ResNet18(num_classes) if kind == "resnet" else MobileNetV2(num_classes)
    _torchvision_init_(net, torch.Generator().manual_seed(seed))
    if checkpoint_path is not None:
        net.load_state_dict(read_classifier_weights(checkpoint_path, kind))
    return ClassifierBundle(kind, net.to(device), image_size, num_classes=num_classes)
