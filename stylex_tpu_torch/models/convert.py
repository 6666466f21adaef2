"""Weight bridges into the port's (reference-layout) state dicts.

* :func:`stylex_state_dict_from_jax` turns the JAX package's StylEx
  parameter tree, given as numpy arrays, into the reference layout: the
  inverse of the JAX package's ``convert_stylex_state_dict``. Linear
  kernels (in, out) become weights (out, in); conv kernels HWIO become OIHW;
  ``initial_block`` (1, 4, 4, C) becomes (1, C, 4, 4); the D/E ``fc`` input
  columns (and a debug encoder's linear layer's) go back from the (H, W, C)
  flatten order to torch's (C, H, W). The attention blocks ``attn{i}`` go
  to the reference's ``attns.{i}`` (G) / ``attn_blocks.{i}`` (D/E)
  nesting; the ``no_const`` stem's (4, 4, latent, C) ``to_initial_block``
  kernel to (latent, C, 4, 4), flipped in both spatial axes (flax's
  ``ConvTranspose`` indexes its taps the other way round from
  ``conv_transpose2d``); the ``vq`` collections ``D_vq`` / ``E_vq`` to the
  quantize layers' buffers.
* :func:`classifier_state_dict_from_jax` does the same for the flax
  ResNet-18 / MobileNetV2 variables, into torchvision's keys.
* :func:`lpips_params_from_jax` does it for the LPIPS tree, and
  :func:`train_state_from_jax` for a whole train state: parameters, EMA
  copies, the optax Adam moments and count, ``step`` and ``pl_mean``.
* :func:`inception_state_dict_from_jax` does it for the FID InceptionV3
  variables, into torchvision's keys.
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
    "lpips_params_from_jax",
    "train_state_from_jax",
    "classifier_state_dict_from_jax",
    "inception_state_dict_from_jax",
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


def _chan_norm(sd: StateDict, key: str, p: Mapping) -> None:
    sd[f"{key}.g"] = _t(np.asarray(p["g"]).reshape(1, -1, 1, 1))
    sd[f"{key}.b"] = _t(np.asarray(p["b"]).reshape(1, -1, 1, 1))


def _attn(sd: StateDict, key: str, p: Mapping) -> None:
    """A flax ``AttnAndFF`` -> the reference's Sequential(Residual(PreNorm(
    LinearAttention)), Residual(PreNorm(Sequential(conv, act, conv))))."""
    a = f"{key}.0.fn.fn"
    _chan_norm(sd, f"{key}.0.fn.norm", p["norm1"])
    _conv(sd, f"{a}.to_q", p["attn"]["to_q"])
    _conv(sd, f"{a}.to_kv.net.0", p["attn"]["to_kv_depth"])
    _conv(sd, f"{a}.to_kv.net.1", p["attn"]["to_kv_point"])
    _conv(sd, f"{a}.to_out", p["attn"]["to_out"])
    _chan_norm(sd, f"{key}.1.fn.norm", p["norm2"])
    _conv(sd, f"{key}.1.fn.fn.0", p["ff1"])
    _conv(sd, f"{key}.1.fn.fn.2", p["ff2"])


def _flat_linear(sd: StateDict, key: str, p: Mapping, channels: int) -> None:
    """A linear layer over a flattened (H, W, C) map -> torch's (C, H, W)
    column order."""
    k = np.asarray(p["kernel"])  # (H*W*C, out)
    out_dim = k.shape[1]
    w = k.T.reshape(out_dim, -1, channels).transpose(0, 2, 1).reshape(out_dim, -1)
    sd[f"{key}.weight"] = _t(w)
    sd[f"{key}.bias"] = _t(p["bias"])


def _debug_encoder(sd: StateDict, prefix: str, p: Mapping) -> None:
    convs = sorted((k for k in p if k.startswith("conv")), key=lambda k: int(k[4:]))
    for k in convs:
        _conv(sd, f"{prefix}.{k}", p[k])
    (fc,) = [k for k in p if not k.startswith("conv")]
    _flat_linear(sd, f"{prefix}.{fc}", p[fc], np.asarray(p[convs[-1]]["kernel"]).shape[-1])


def _vq(sd: StateDict, prefix: str, tree: Mapping) -> None:
    """A flax ``vq`` collection {codebook{i}, cluster{i}, avg{i}} -> the
    buffers of ``{prefix}.quantize_blocks.{i}``."""
    for k, v in tree.items():
        if k.startswith("codebook"):
            i = k[len("codebook"):]
            q = f"{prefix}.quantize_blocks.{i}"
            sd[f"{q}.codebook"] = _t(v)
            sd[f"{q}.cluster_size"] = _t(tree[f"cluster{i}"])
            sd[f"{q}.embed_avg"] = _t(tree[f"avg{i}"])


def _mapping(sd: StateDict, prefix: str, p: Mapping, depth: int) -> None:
    for i in range(depth):
        _linear(sd, f"{prefix}.net.{2 * i}", p[f"fc{i}"])


def _generator(sd: StateDict, prefix: str, p: Mapping, cfg: ModelConfig) -> None:
    if "initial_block" in p:
        sd[f"{prefix}.initial_block"] = _t(np.asarray(p["initial_block"]).transpose(0, 3, 1, 2))
    else:  # no_const
        k = np.asarray(p["to_initial_block"]["kernel"])  # (4, 4, latent, C)
        sd[f"{prefix}.to_initial_block.weight"] = _t(np.ascontiguousarray(
            k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]))
    _conv(sd, f"{prefix}.initial_conv", p["initial_conv"])
    n_blocks = len(generator_filters(cfg.image_size, cfg.network_capacity, cfg.fmap_max)) - 1
    hwio_to_oihw = lambda w: _t(np.asarray(w).transpose(3, 2, 0, 1))
    for i in range(n_blocks):
        if f"attn{i}" in p:
            _attn(sd, f"{prefix}.attns.{i}", p[f"attn{i}"])
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
        if f"attn{i}" in p:
            _attn(sd, f"{prefix}.attn_blocks.{i}", p[f"attn{i}"])
    _conv(sd, f"{prefix}.final_conv", p["final_conv"])
    _flat_linear(sd, f"{prefix}.fc", p["fc"], filters[-1])


def _subtree_state_dict(name: str, tree: Mapping, cfg: ModelConfig) -> StateDict:
    """One of the JAX trees 'encoder', 'S', 'G', 'D', 'SE', 'GE' (or a tree
    shaped like it, such as an Adam moment) -> ``{'<name>.<key>': tensor}``."""
    sd: StateDict = {}
    if name in ("S", "SE"):
        _mapping(sd, name, tree, cfg.style_depth)
    elif name in ("G", "GE"):
        _generator(sd, name, tree, cfg)
    elif name == "encoder" and cfg.encoder_class is not None:
        _debug_encoder(sd, name, tree)
    else:
        _trunk(sd, name, tree, cfg)
    return sd


def stylex_state_dict_from_jax(params: Mapping[str, Any], cfg: ModelConfig) -> StateDict:
    """The JAX package's StylEx tree {'encoder','S','G','D','SE','GE'} and,
    with ``fq_layers``, 'D_vq' and 'E_vq' (numpy leaves) -> the port's state
    dict."""
    sd: StateDict = {}
    for name in ("encoder", "S", "G", "D", "SE", "GE"):
        sd.update(_subtree_state_dict(name, params[name], cfg))
    for name, prefix in (("D_vq", "D"), ("E_vq", "encoder")):
        if name in params:
            _vq(sd, prefix, params[name])
    return sd


def lpips_params_from_jax(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX package's LPIPS tree ``{'conv{i}': {'kernel' HWIO, 'bias'},
    'lin{i}'}`` (numpy leaves) -> the port's ``{'conv{i}': {'weight' OIHW,
    'bias'}, 'lin{i}'}``."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k.startswith("conv"):
            out[k] = {"weight": _t(np.asarray(v["kernel"]).transpose(3, 2, 0, 1)),
                      "bias": _t(v["bias"])}
        else:
            out[k] = _t(v)
    return out


def _adam_states(opt_state) -> Dict[str, Any]:
    """The optax Adam states in a JAX optimizer state, by label: ``{'': s}``
    for a plain ``optax.adam``, ``{'gen': s, 'enc': s}`` for the NEW arch's
    ``multi_transform``. Read by attribute, so no optax is imported."""
    if hasattr(opt_state, "inner_states"):  # multi_transform's PartitionState
        return {label: _adam_states(s)[""] for label, s in opt_state.inner_states.items()}
    if hasattr(opt_state, "inner_state"):  # MaskedState
        return _adam_states(opt_state.inner_state)
    if hasattr(opt_state, "mu"):
        return {"": opt_state}
    for s in opt_state:  # chain's tuple: the Adam state is one element
        if hasattr(s, "mu") or hasattr(s, "inner_state") or hasattr(s, "inner_states"):
            return _adam_states(s)
    raise ValueError("no Adam state found in the JAX optimizer state")


def _load_adam(opt: torch.optim.Optimizer, params: Dict[str, torch.nn.Parameter], count,
               moments: Dict[str, tuple], cfg: ModelConfig) -> None:
    """Copy optax Adam moments ``{subtree name: (mu, nu)}`` and ``count``
    into ``opt``'s per-parameter state."""
    step = torch.tensor(float(np.asarray(count)))
    for name, (mu_tree, nu_tree) in moments.items():
        mu = _subtree_state_dict(name, mu_tree, cfg)
        nu = _subtree_state_dict(name, nu_tree, cfg)
        for key in mu:
            p = params[key]
            opt.state[p] = {"step": step.clone(), "exp_avg": mu[key].to(p.device),
                            "exp_avg_sq": nu[key].to(p.device)}


def train_state_from_jax(jax_state, model_cfg: ModelConfig, train_cfg, device=None):
    """The JAX package's ``StylExTrainState`` (numpy or JAX leaves) -> the
    port's :class:`~stylex_tpu_torch.train.state.TrainState`: live and EMA
    parameters, the quantize layers' codebooks, the optax Adam
    ``mu``/``nu``/``count`` of G (per label in the NEW arch) and D,
    ``step`` and ``pl_mean``. Placed on ``device`` (the GPU unless
    ``'cpu'``)."""
    from stylex_tpu_torch.device import resolve_device
    from stylex_tpu_torch.models.stylex import StylEx
    from stylex_tpu_torch.train.state import create_train_state

    device = resolve_device(device)
    tree = {**jax_state.params, **jax_state.ema_params}
    model = StylEx(model_cfg)
    model.load_state_dict(stylex_state_dict_from_jax(tree, model_cfg))
    state = create_train_state(model.to(device), model_cfg, train_cfg)
    params = dict(state.model.named_parameters())
    g_adam = _adam_states(jax_state.g_opt_state)
    for name in ("encoder", "S", "G"):
        # one Adam over encoder/S/G, or the NEW arch's 'enc' and 'gen' labels
        adam = g_adam[""] if "" in g_adam else g_adam["enc" if name == "encoder" else "gen"]
        _load_adam(state.g_opt, params, adam.count,
                   {name: (adam.mu[name], adam.nu[name])}, model_cfg)
    d_adam = _adam_states(jax_state.d_opt_state)[""]
    _load_adam(state.d_opt, params, d_adam.count, {"D": (d_adam.mu, d_adam.nu)}, model_cfg)
    state.step = int(np.asarray(jax_state.step))
    state.pl_mean = torch.tensor(float(np.asarray(jax_state.pl_mean)), device=device)
    return state


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


def inception_state_dict_from_jax(variables: Mapping[str, Any]) -> StateDict:
    """flax ``{'params', 'batch_stats'}`` of the JAX package's
    ``InceptionV3FID`` (numpy leaves) -> a torchvision-layout state dict:
    ``<path>.conv.kernel`` HWIO -> ``<path>.conv.weight`` OIHW,
    ``<path>.bn.{scale, bias}`` -> ``.bn.{weight, bias}``, the statistics
    ``<path>.bn.{mean, var}`` -> ``.bn.{running_mean, running_var}``."""
    sd: StateDict = {}

    def walk(tree: Mapping, path: str, names: Mapping[str, str]) -> None:
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{path}{k}.", names)
            elif k == "kernel":
                sd[f"{path}weight"] = _t(np.asarray(v).transpose(3, 2, 0, 1))
            else:
                sd[f"{path}{names[k]}"] = _t(v)

    walk(variables["params"], "", {"scale": "weight", "bias": "bias"})
    walk(variables["batch_stats"], "", {"mean": "running_mean", "var": "running_var"})
    for key in [k for k in sd if k.endswith(".bn.running_var")]:
        sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
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
