"""Weight bridges into the port's (reference-layout) state dicts.

* :func:`stylex_state_dict_from_jax` turns the JAX package's StylEx
  parameter tree, given as numpy arrays, into the reference layout: the
  inverse of the JAX package's ``convert_stylex_state_dict``. Linear
  kernels (in, out) become weights (out, in); conv kernels HWIO become OIHW;
  ``initial_block`` (1, 4, 4, C) becomes (1, C, 4, 4); the D/E ``fc`` input
  columns go back from the (2, 2, C) flatten order to torch's (C, 2, 2).
* :func:`classifier_state_dict_from_jax` does the same for the flax
  ResNet-18 / MobileNetV2 variables, into torchvision's keys.
* :func:`load_reference_checkpoint` reads a reference ``.pt`` file.

No JAX is needed: the trees are nested mappings of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from stylex_tpu_torch.config import ModelConfig
from stylex_tpu_torch.models.classifiers import _MBV2_PLAN
from stylex_tpu_torch.models.discriminator import discriminator_filters
from stylex_tpu_torch.models.generator import generator_filters

__all__ = [
    "stylex_state_dict_from_jax",
    "classifier_state_dict_from_jax",
    "load_reference_checkpoint",
]

StateDict = Dict[str, torch.Tensor]

# the reference checkpoint's top-level modules that the port holds; others
# (e.g. the augmentation wrapper's alias of D) are dropped on load
_STYLEX_PREFIXES = ("encoder.", "S.", "G.", "D.", "SE.", "GE.")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _mapping(sd: StateDict, prefix: str, p: Mapping, depth: int) -> None:
    for i in range(depth):
        _linear(sd, f"{prefix}.net.{2 * i}", p[f"fc{i}"])


def _generator(sd: StateDict, prefix: str, p: Mapping, cfg: ModelConfig) -> None:
    sd[f"{prefix}.initial_block"] = _t(np.asarray(p["initial_block"]).transpose(0, 3, 1, 2))
    _conv(sd, f"{prefix}.initial_conv", p["initial_conv"])
    n_blocks = len(generator_filters(cfg.image_size, cfg.network_capacity, cfg.fmap_max)) - 1
    hwio_to_oihw = lambda w: _t(np.asarray(w).transpose(3, 2, 0, 1))
    for i in range(n_blocks):
        b, q = f"{prefix}.blocks.{i}", p[f"block{i}"]
        for name in ("to_style1", "to_noise1", "to_style2", "to_noise2"):
            _linear(sd, f"{b}.{name}", q[name])
        sd[f"{b}.conv1.weight"] = hwio_to_oihw(q["conv1_weight"])
        sd[f"{b}.conv2.weight"] = hwio_to_oihw(q["conv2_weight"])
        _linear(sd, f"{b}.to_rgb.to_style", q["to_rgb"]["to_style"])
        sd[f"{b}.to_rgb.conv.weight"] = hwio_to_oihw(q["to_rgb"]["conv_weight"])


def _trunk(sd: StateDict, prefix: str, p: Mapping, cfg: ModelConfig) -> None:
    filters = discriminator_filters(cfg.image_size, cfg.network_capacity, cfg.fmap_max)
    for i in range(len(filters) - 1):
        b, q = f"{prefix}.blocks.{i}", p[f"block{i}"]
        _conv(sd, f"{b}.conv_res", q["conv_res"])
        _conv(sd, f"{b}.net.0", q["conv1"])
        _conv(sd, f"{b}.net.2", q["conv2"])
        if "conv_down" in q:
            _conv(sd, f"{b}.downsample.1", q["conv_down"])
    _conv(sd, f"{prefix}.final_conv", p["final_conv"])
    chan_last = filters[-1]
    k = np.asarray(p["fc"]["kernel"])  # (2*2*C, out), rows in (2, 2, C) order
    out_dim = k.shape[1]
    w = k.T.reshape(out_dim, 2, 2, chan_last).transpose(0, 3, 1, 2).reshape(out_dim, -1)
    sd[f"{prefix}.fc.weight"] = _t(w)
    sd[f"{prefix}.fc.bias"] = _t(p["fc"]["bias"])


def stylex_state_dict_from_jax(params: Mapping[str, Any], cfg: ModelConfig) -> StateDict:
    """The JAX package's StylEx tree {'encoder','S','G','D','SE','GE'} (numpy
    leaves) -> the port's state dict."""
    if cfg.encoder_class is not None:
        raise NotImplementedError("debug encoders are not ported yet")
    sd: StateDict = {}
    _trunk(sd, "encoder", params["encoder"], cfg)
    _mapping(sd, "S", params["S"], cfg.style_depth)
    _generator(sd, "G", params["G"], cfg)
    _trunk(sd, "D", params["D"], cfg)
    _mapping(sd, "SE", params["SE"], cfg.style_depth)
    _generator(sd, "GE", params["GE"], cfg)
    return sd


def _convbn(sd: StateDict, conv_key: str, bn_key: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{conv_key}.weight"] = _t(np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{bn_key}.weight"] = _t(params["bn"]["scale"])
    sd[f"{bn_key}.bias"] = _t(params["bn"]["bias"])
    sd[f"{bn_key}.running_mean"] = _t(stats["bn"]["mean"])
    sd[f"{bn_key}.running_var"] = _t(stats["bn"]["var"])
    sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def classifier_state_dict_from_jax(variables: Mapping[str, Any], kind: str) -> StateDict:
    """flax ``{'params', 'batch_stats'}`` of the JAX package's ResNet18 /
    MobileNetV2 (numpy leaves) -> a torchvision-layout state dict."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    if kind == "resnet":
        _convbn(sd, "conv1", "bn1", p["stem"], s["stem"])
        for layer in range(1, 5):
            for blk in range(2):
                name, prefix = f"layer{layer}_{blk}", f"layer{layer}.{blk}"
                for j in (1, 2):
                    _convbn(sd, f"{prefix}.conv{j}", f"{prefix}.bn{j}",
                            p[name][f"conv{j}"], s[name][f"conv{j}"])
                if "downsample" in p[name]:
                    _convbn(sd, f"{prefix}.downsample.0", f"{prefix}.downsample.1",
                            p[name]["downsample"], s[name]["downsample"])
        _linear(sd, "fc", p["fc"])
    elif kind == "mobilenet":
        _convbn(sd, "features.0.0", "features.0.1", p["stem"], s["stem"])
        idx = 0
        for t, _, n, _ in _MBV2_PLAN:
            for _ in range(n):
                prefix, name = f"features.{idx + 1}.conv", f"block{idx}"
                k = 0
                if t != 1:
                    _convbn(sd, f"{prefix}.0.0", f"{prefix}.0.1", p[name]["expand"], s[name]["expand"])
                    k = 1
                _convbn(sd, f"{prefix}.{k}.0", f"{prefix}.{k}.1",
                        p[name]["depthwise"], s[name]["depthwise"])
                _convbn(sd, f"{prefix}.{k + 1}", f"{prefix}.{k + 2}",
                        p[name]["project"], s[name]["project"])
                idx += 1
        _convbn(sd, "features.18.0", "features.18.1", p["head"], s["head"])
        _linear(sd, "classifier.1", p["classifier"])
    else:
        raise ValueError(f"unknown classifier kind {kind!r}")
    return sd


def load_reference_checkpoint(path: str) -> StateDict:
    """A reference ``model_<n>.pt`` (``{'StylEx': state_dict, ...}`` or a bare
    state dict) -> the state dict that :class:`StylEx` loads.

    The blur tap buffers (``...upsample.1.f``, ``...downsample.0.f``) hold
    constants that the port computes in its kernels, and keys outside the
    bundle's six modules are not part of the model; both are dropped.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["StylEx"] if "StylEx" in ckpt else ckpt
    return {
        k: v for k, v in sd.items()
        if k.startswith(_STYLEX_PREFIXES)
        and not k.endswith((".upsample.1.f", ".downsample.0.f"))
    }
