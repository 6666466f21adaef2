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
* :func:`google_generator_from_jax` builds the port's
  :class:`~stylex_tpu_torch.models.google_stylex.GoogleStylExGenerator`
  from the JAX package's Google-generator tree: HWIO conv kernels to OIHW,
  the (1, 4, 4, C) NHWC constant to NCHW; the style affines keep their
  (dlatent, C) layout.
* :func:`load_reference_checkpoint` reads a reference ``.pt`` file.
* Each bridge has its exact inverse (transposes, reshapes and flips only),
  port -> JAX: :func:`stylex_state_dict_to_jax`, :func:`train_state_to_jax`
  (which the port's ``save_jax_checkpoint`` writes),
  :func:`classifier_tree_from_state_dict`, :func:`lpips_tree_from_params`
  and :func:`inception_tree_from_state_dict` (which ``ingest`` writes).

No JAX is needed: the trees are nested mappings of numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from stylex_tpu_torch.config import ModelConfig
from stylex_tpu_torch.device import resolve_device
from stylex_tpu_torch.models.classifiers import _MBV2_PLAN
from stylex_tpu_torch.models.discriminator import discriminator_filters
from stylex_tpu_torch.models.generator import generator_filters
from stylex_tpu_torch.models.google_stylex import GoogleStylExGenerator, GoogleStylExSpec

__all__ = [
    "stylex_state_dict_from_jax",
    "lpips_params_from_jax",
    "train_state_from_jax",
    "load_train_state_from_jax",
    "stylex_state_dict_to_jax",
    "train_state_to_jax",
    "classifier_state_dict_from_jax",
    "inception_state_dict_from_jax",
    "classifier_tree_from_state_dict",
    "lpips_tree_from_params",
    "google_generator_from_jax",
    "inception_tree_from_state_dict",
    "load_reference_checkpoint",
]

StateDict = Dict[str, torch.Tensor]

# the reference checkpoint's top-level modules that the port holds; others
# (e.g. the augmentation wrapper's alias of D) are dropped on load
_STYLEX_PREFIXES = ("encoder.", "S.", "G.", "D.", "SE.", "GE.")


def _t(a) -> torch.Tensor:
    """A float32 tensor of leaf ``a``: a view of it where it is a writable
    float32 numpy array (a leaf of a file read by
    :func:`~stylex_tpu_torch.utils.flax_msgpack.load`, so a checkpoint is
    copied once, into place), else a copy."""
    if torch.is_tensor(a):
        return a.float()
    arr = np.asarray(a, dtype=np.float32)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


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


def _get(node, key: str):
    """``node[key]`` of a state-dict tree, ``node.key`` of an optax state;
    None where there is none."""
    return node.get(key) if isinstance(node, Mapping) else getattr(node, key, None)


def _adam_states(opt_state) -> Dict[str, tuple]:
    """The optax Adam states in a JAX optimizer state as ``(count, mu,
    nu)``, by label: ``{'': s}`` for a plain ``optax.adam``, ``{'gen': s,
    'enc': s}`` for the NEW arch's ``multi_transform``. Takes the optax
    objects (read by attribute, so no optax is imported) or their
    state-dict form, as a checkpoint stores it (a chain's tuple as
    ``{'0': ..., '1': ...}``)."""
    inner = _get(opt_state, "inner_states")  # multi_transform's PartitionState
    if inner is not None:
        return {label: _adam_states(s)[""] for label, s in inner.items()}
    inner = _get(opt_state, "inner_state")  # MaskedState
    if inner is not None:
        return _adam_states(inner)
    if _get(opt_state, "mu") is not None:
        return {"": (_get(opt_state, "count"), _get(opt_state, "mu"), _get(opt_state, "nu"))}
    children = opt_state.values() if isinstance(opt_state, Mapping) else opt_state
    for s in children:  # chain's tuple: the Adam state is one element
        if any(_get(s, k) is not None for k in ("mu", "inner_state", "inner_states")):
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
            opt.state[p] = {"step": step.clone(),
                            "exp_avg": torch.empty_like(p).copy_(mu[key]),
                            "exp_avg_sq": torch.empty_like(p).copy_(nu[key])}


def load_train_state_from_jax(jax_state, state) -> None:
    """Restore the JAX package's ``StylExTrainState``, or its state-dict
    form as a ``.ckpt`` holds it under ``'state'`` (numpy or JAX leaves),
    into the port's :class:`~stylex_tpu_torch.train.state.TrainState` in
    place: live and EMA parameters, the quantize layers' codebooks, the
    optax Adam ``mu``/``nu``/``count`` of G (per label in the NEW arch: the
    other label's masked leaves are never read) and D, ``step`` and
    ``pl_mean``."""
    cfg = state.model.cfg
    field = lambda name: _get(jax_state, name)
    state.model.load_state_dict(
        stylex_state_dict_from_jax({**field("params"), **field("ema_params")}, cfg))
    params = dict(state.model.named_parameters())
    state.g_opt.state.clear()
    state.d_opt.state.clear()
    g_adam = _adam_states(field("g_opt_state"))
    for name in ("encoder", "S", "G"):
        # one Adam over encoder/S/G, or the NEW arch's 'enc' and 'gen' labels
        count, mu, nu = g_adam[""] if "" in g_adam else g_adam["enc" if name == "encoder" else "gen"]
        _load_adam(state.g_opt, params, count, {name: (mu[name], nu[name])}, cfg)
    count, mu, nu = _adam_states(field("d_opt_state"))[""]
    _load_adam(state.d_opt, params, count, {"D": (mu, nu)}, cfg)
    state.step = int(np.asarray(field("step")))
    state.pl_mean = torch.tensor(float(np.asarray(field("pl_mean"))), device=state.device)


def train_state_from_jax(jax_state, model_cfg: ModelConfig, train_cfg, device=None):
    """:func:`load_train_state_from_jax` into a new
    :class:`~stylex_tpu_torch.train.state.TrainState` on ``device`` (the GPU
    unless ``'cpu'``)."""
    from stylex_tpu_torch.device import resolve_device
    from stylex_tpu_torch.models.stylex import StylEx
    from stylex_tpu_torch.train.state import create_train_state

    state = create_train_state(StylEx(model_cfg).to(resolve_device(device)), model_cfg,
                               train_cfg)
    load_train_state_from_jax(jax_state, state)
    return state


# --------------------------------------------------- port -> JAX (inverse)
# Each function below inverts the one of the same name without ``_to_jax``
# exactly: transposes, reshapes and flips only, so a round trip is bit for
# bit. Leaves are float32 numpy arrays on the host.


def _n(t: torch.Tensor) -> np.ndarray:
    """float32 numpy on the host; float64 stays float64."""
    t = t.detach().to("cpu")
    return (t if t.dtype == torch.float64 else t.float()).numpy()


def _linear_to_jax(sd: StateDict, key: str) -> Dict[str, np.ndarray]:
    p = {"kernel": _n(sd[f"{key}.weight"]).T}
    if f"{key}.bias" in sd:
        p["bias"] = _n(sd[f"{key}.bias"])
    return p


def _conv_to_jax(sd: StateDict, key: str) -> Dict[str, np.ndarray]:
    p = {"kernel": _n(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        p["bias"] = _n(sd[f"{key}.bias"])
    return p


def _chan_norm_to_jax(sd: StateDict, key: str) -> Dict[str, np.ndarray]:
    return {"g": _n(sd[f"{key}.g"]).reshape(-1), "b": _n(sd[f"{key}.b"]).reshape(-1)}


def _attn_to_jax(sd: StateDict, key: str) -> Dict[str, Any]:
    a = f"{key}.0.fn.fn"
    return {"norm1": _chan_norm_to_jax(sd, f"{key}.0.fn.norm"),
            "attn": {"to_q": _conv_to_jax(sd, f"{a}.to_q"),
                     "to_kv_depth": _conv_to_jax(sd, f"{a}.to_kv.net.0"),
                     "to_kv_point": _conv_to_jax(sd, f"{a}.to_kv.net.1"),
                     "to_out": _conv_to_jax(sd, f"{a}.to_out")},
            "norm2": _chan_norm_to_jax(sd, f"{key}.1.fn.norm"),
            "ff1": _conv_to_jax(sd, f"{key}.1.fn.fn.0"),
            "ff2": _conv_to_jax(sd, f"{key}.1.fn.fn.2")}


def _flat_linear_to_jax(sd: StateDict, key: str, channels: int) -> Dict[str, np.ndarray]:
    w = _n(sd[f"{key}.weight"])  # (out, C*H*W), torch's (C, H, W) order
    out_dim = w.shape[0]
    k = w.reshape(out_dim, channels, -1).transpose(0, 2, 1).reshape(out_dim, -1).T
    return {"kernel": k, "bias": _n(sd[f"{key}.bias"])}


def _modules_under(sd: StateDict, prefix: str) -> list:
    return sorted({k[len(prefix) + 1:].split(".")[0] for k in sd if k.startswith(prefix + ".")})


def _debug_encoder_to_jax(sd: StateDict, prefix: str) -> Dict[str, Any]:
    names = _modules_under(sd, prefix)
    convs = sorted((k for k in names if k.startswith("conv")), key=lambda k: int(k[4:]))
    p = {k: _conv_to_jax(sd, f"{prefix}.{k}") for k in convs}
    (fc,) = [k for k in names if not k.startswith("conv")]
    p[fc] = _flat_linear_to_jax(sd, f"{prefix}.{fc}", sd[f"{prefix}.{convs[-1]}.weight"].shape[0])
    return p


def _vq_to_jax(sd: StateDict, prefix: str) -> Dict[str, np.ndarray]:
    tree = {}
    for i in _modules_under(sd, f"{prefix}.quantize_blocks"):
        q = f"{prefix}.quantize_blocks.{i}"
        tree[f"codebook{i}"] = _n(sd[f"{q}.codebook"])
        tree[f"cluster{i}"] = _n(sd[f"{q}.cluster_size"])
        tree[f"avg{i}"] = _n(sd[f"{q}.embed_avg"])
    return tree


def _mapping_to_jax(sd: StateDict, prefix: str, depth: int) -> Dict[str, Any]:
    return {f"fc{i}": _linear_to_jax(sd, f"{prefix}.net.{2 * i}") for i in range(depth)}


def _generator_to_jax(sd: StateDict, prefix: str, cfg: ModelConfig) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    if f"{prefix}.initial_block" in sd:
        p["initial_block"] = _n(sd[f"{prefix}.initial_block"]).transpose(0, 2, 3, 1)
    else:  # no_const: undo the flip of both spatial axes
        w = _n(sd[f"{prefix}.to_initial_block.weight"])  # (latent, C, 4, 4)
        p["to_initial_block"] = {"kernel": w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)}
    p["initial_conv"] = _conv_to_jax(sd, f"{prefix}.initial_conv")
    n_blocks = len(generator_filters(cfg.image_size, cfg.network_capacity, cfg.fmap_max)) - 1
    oihw_to_hwio = lambda key: _n(sd[key]).transpose(2, 3, 1, 0)
    for i in range(n_blocks):
        if f"{prefix}.attns.{i}.0.fn.norm.g" in sd:
            p[f"attn{i}"] = _attn_to_jax(sd, f"{prefix}.attns.{i}")
        b = f"{prefix}.blocks.{i}"
        q = {name: _linear_to_jax(sd, f"{b}.{name}")
             for name in ("to_style1", "to_noise1", "to_style2", "to_noise2")}
        q["conv1_weight"] = oihw_to_hwio(f"{b}.conv1.weight")
        q["conv2_weight"] = oihw_to_hwio(f"{b}.conv2.weight")
        q["to_rgb"] = {"to_style": _linear_to_jax(sd, f"{b}.to_rgb.to_style"),
                       "conv_weight": oihw_to_hwio(f"{b}.to_rgb.conv.weight")}
        p[f"block{i}"] = q
    return p


def _trunk_to_jax(sd: StateDict, prefix: str, cfg: ModelConfig) -> Dict[str, Any]:
    filters = discriminator_filters(cfg.image_size, cfg.network_capacity, cfg.fmap_max)
    p: Dict[str, Any] = {}
    for i in range(len(filters) - 1):
        b = f"{prefix}.blocks.{i}"
        q = {"conv_res": _conv_to_jax(sd, f"{b}.conv_res"),
             "conv1": _conv_to_jax(sd, f"{b}.net.0"),
             "conv2": _conv_to_jax(sd, f"{b}.net.2")}
        if f"{b}.downsample.1.weight" in sd:
            q["conv_down"] = _conv_to_jax(sd, f"{b}.downsample.1")
        p[f"block{i}"] = q
        if f"{prefix}.attn_blocks.{i}.0.fn.norm.g" in sd:
            p[f"attn{i}"] = _attn_to_jax(sd, f"{prefix}.attn_blocks.{i}")
    p["final_conv"] = _conv_to_jax(sd, f"{prefix}.final_conv")
    p["fc"] = _flat_linear_to_jax(sd, f"{prefix}.fc", filters[-1])
    return p


def _subtree_to_jax(name: str, sd: StateDict, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`_subtree_state_dict`: the port's keys under
    ``name`` (parameters, or tensors shaped like them such as Adam moments)
    -> the JAX tree ``name``."""
    if name in ("S", "SE"):
        return _mapping_to_jax(sd, name, cfg.style_depth)
    if name in ("G", "GE"):
        return _generator_to_jax(sd, name, cfg)
    if name == "encoder" and cfg.encoder_class is not None:
        return _debug_encoder_to_jax(sd, name)
    return _trunk_to_jax(sd, name, cfg)


def stylex_state_dict_to_jax(sd: StateDict, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`stylex_state_dict_from_jax`: the port's state
    dict -> the JAX package's tree {'encoder','S','G','D','SE','GE'} and,
    with quantize layers, 'D_vq' and 'E_vq'."""
    tree = {name: _subtree_to_jax(name, sd, cfg) for name in ("encoder", "S", "G", "D", "SE", "GE")}
    for name, prefix in (("D_vq", "D"), ("E_vq", "encoder")):
        if any(k.startswith(f"{prefix}.quantize_blocks.") for k in sd):
            tree[name] = _vq_to_jax(sd, prefix)
    return tree


def _masked(tree) -> Dict[str, Any]:
    """optax's ``MaskedNode`` leaves, as a state dict holds them: the
    tree's structure with an empty dict at every leaf."""
    return {k: _masked(v) if isinstance(v, Mapping) else {} for k, v in tree.items()}


def _adam_to_jax(opt: torch.optim.Optimizer, named: Dict[str, torch.nn.Parameter],
                 names, cfg: ModelConfig, masked=()) -> Dict[str, Any]:
    """One optax ``adam`` state (``chain(scale_by_adam, scale_by_lr)``) in
    state-dict form from ``opt``'s state over the subtrees ``names``;
    subtrees in ``masked`` get ``MaskedNode`` leaves. A parameter with no
    state yet (the optimizer has not stepped) has zero moments, count 0."""
    mu, nu, count = {}, {}, 0
    for key, p in named.items():
        if key.split(".")[0] not in names:
            continue
        st = opt.state.get(p)
        if st:
            count = int(st["step"])
        mu[key] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[key] = st["exp_avg_sq"] if st else torch.zeros_like(p)
    mu_tree = {name: _subtree_to_jax(name, mu, cfg) for name in names}
    nu_tree = {name: _subtree_to_jax(name, nu, cfg) for name in names}
    for name in masked:
        mu_tree[name] = nu_tree[name] = _masked(_subtree_to_jax(name, named, cfg))
    if names == ("D",):
        mu_tree, nu_tree = mu_tree["D"], nu_tree["D"]
    return {"0": {"count": np.asarray(count, np.int32), "mu": mu_tree, "nu": nu_tree}, "1": {}}


def train_state_to_jax(state) -> Dict[str, Any]:
    """The inverse of :func:`load_train_state_from_jax`: the port's
    :class:`~stylex_tpu_torch.train.state.TrainState` -> the state-dict
    form of the JAX package's ``StylExTrainState``, which its
    ``load_checkpoint`` restores: ``step``, ``params``, ``ema_params``, the
    G optimizer state (one Adam, or the NEW arch's ``multi_transform`` over
    the 'enc' and 'gen' labels with the other label's leaves masked), the D
    optimizer state and ``pl_mean``."""
    from stylex_tpu_torch.config import Arch

    cfg = state.model.cfg
    tree = stylex_state_dict_to_jax(state.model.state_dict(), cfg)
    named = dict(state.model.named_parameters())
    if cfg.arch == Arch.NEW:
        g_opt_state = {"inner_states": {
            "enc": {"inner_state": _adam_to_jax(state.g_opt, named, ("encoder",), cfg,
                                                masked=("S", "G"))},
            "gen": {"inner_state": _adam_to_jax(state.g_opt, named, ("S", "G"), cfg,
                                                masked=("encoder",))}}}
    else:
        g_opt_state = _adam_to_jax(state.g_opt, named, ("encoder", "S", "G"), cfg)
    return {
        "step": np.asarray(state.step, np.int32),
        "params": {k: v for k, v in tree.items() if k not in ("SE", "GE")},
        "ema_params": {"SE": tree["SE"], "GE": tree["GE"]},
        "g_opt_state": g_opt_state,
        "d_opt_state": _adam_to_jax(state.d_opt, named, ("D",), cfg),
        "pl_mean": np.asarray(float(state.pl_mean), np.float32),
    }


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


def _convbn_to_jax(sd: StateDict, conv_key: str, bn_key: str):
    return ({"conv": {"kernel": _n(sd[f"{conv_key}.weight"]).transpose(2, 3, 1, 0)},
             "bn": {"scale": _n(sd[f"{bn_key}.weight"]), "bias": _n(sd[f"{bn_key}.bias"])}},
            {"bn": {"mean": _n(sd[f"{bn_key}.running_mean"]),
                    "var": _n(sd[f"{bn_key}.running_var"])}})


def classifier_tree_from_state_dict(sd: Mapping[str, torch.Tensor], kind: str) -> Dict[str, Any]:
    """The inverse of :func:`classifier_state_dict_from_jax`: a
    torchvision-layout ResNet-18 / MobileNetV2 state dict -> the JAX
    package's flax ``{'params', 'batch_stats'}`` (float32 numpy leaves), as
    its ``convert_resnet18_state_dict`` / ``convert_mobilenet_v2_state_dict``
    build them. ``num_batches_tracked`` has no flax counterpart."""
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    if kind == "resnet":
        p["stem"], s["stem"] = _convbn_to_jax(sd, "conv1", "bn1")
        for layer in range(1, 5):
            for blk in range(2):
                name, prefix = f"layer{layer}_{blk}", f"layer{layer}.{blk}"
                p[name], s[name] = {}, {}
                for j in (1, 2):
                    p[name][f"conv{j}"], s[name][f"conv{j}"] = _convbn_to_jax(
                        sd, f"{prefix}.conv{j}", f"{prefix}.bn{j}")
                if f"{prefix}.downsample.0.weight" in sd:
                    p[name]["downsample"], s[name]["downsample"] = _convbn_to_jax(
                        sd, f"{prefix}.downsample.0", f"{prefix}.downsample.1")
        p["fc"] = _linear_to_jax(sd, "fc")
    elif kind == "mobilenet":
        p["stem"], s["stem"] = _convbn_to_jax(sd, "features.0.0", "features.0.1")
        idx = 0
        for t, _, n, _ in _MBV2_PLAN:
            for _ in range(n):
                prefix, name = f"features.{idx + 1}.conv", f"block{idx}"
                p[name], s[name] = {}, {}
                k = 0
                if t != 1:
                    p[name]["expand"], s[name]["expand"] = _convbn_to_jax(
                        sd, f"{prefix}.0.0", f"{prefix}.0.1")
                    k = 1
                p[name]["depthwise"], s[name]["depthwise"] = _convbn_to_jax(
                    sd, f"{prefix}.{k}.0", f"{prefix}.{k}.1")
                p[name]["project"], s[name]["project"] = _convbn_to_jax(
                    sd, f"{prefix}.{k + 1}", f"{prefix}.{k + 2}")
                idx += 1
        p["head"], s["head"] = _convbn_to_jax(sd, "features.18.0", "features.18.1")
        p["classifier"] = _linear_to_jax(sd, "classifier.1")
    else:
        raise ValueError(f"unknown classifier kind {kind!r}")
    return {"params": p, "batch_stats": s}


def lpips_tree_from_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`lpips_params_from_jax`: the port's LPIPS
    params -> the JAX package's tree ``{'conv{i}': {'kernel' HWIO, 'bias'},
    'lin{i}'}``."""
    return {k: ({"kernel": _n(v["weight"]).transpose(2, 3, 1, 0), "bias": _n(v["bias"])}
                if k.startswith("conv") else _n(v))
            for k, v in params.items()}


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


def inception_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`inception_state_dict_from_jax`: a torchvision
    / pytorch_fid ``inception_v3`` state dict -> the JAX package's flax
    ``{'params', 'batch_stats'}`` of ``InceptionV3FID``, as its
    ``convert_inception_state_dict`` builds it (``fc``, ``AuxLogits`` and
    ``num_batches_tracked`` dropped)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    names = {("conv", "weight"): (params, "kernel"), ("bn", "weight"): (params, "scale"),
             ("bn", "bias"): (params, "bias"), ("bn", "running_mean"): (stats, "mean"),
             ("bn", "running_var"): (stats, "var")}
    for key, val in sd.items():
        parts = key.split(".")
        *path, unit, param = parts
        if parts[0] in ("fc", "AuxLogits") or (unit, param) not in names:
            continue
        tree, leaf = names[(unit, param)]
        for part in path + [unit]:
            tree = tree.setdefault(part, {})
        v = val if torch.is_tensor(val) else torch.from_numpy(np.asarray(val))
        tree[leaf] = _n(v).transpose(2, 3, 1, 0) if leaf == "kernel" else _n(v)
    return {"params": params, "batch_stats": stats}


def google_generator_from_jax(params: Mapping[str, Any], spec, device=None):
    """The JAX package's Google-generator tree (``{"const", "convs":
    [{"weight", "bias", "style_kernel", "style_bias"}], "torgbs": [...]}``,
    numpy) -> a ``GoogleStylExGenerator`` on ``device`` (the GPU unless
    ``'cpu'``). ``spec`` is any object with ``image_size``, ``dlatent_dim``
    and ``channels`` (resolution -> channels), the JAX package's
    ``GoogleStylExGenerator`` among them."""
    spec = GoogleStylExSpec(image_size=int(spec.image_size), dlatent_dim=int(spec.dlatent_dim),
                            channels_map=tuple(sorted((int(r), int(c))
                                                      for r, c in spec.channels.items())))
    sd: StateDict = {"const": _t(np.asarray(params["const"]).transpose(0, 3, 1, 2))}
    for group in ("convs", "torgbs"):
        for i, p in enumerate(params[group]):
            sd[f"{group}.{i}.weight"] = _t(np.asarray(p["weight"]).transpose(3, 2, 0, 1))
            sd[f"{group}.{i}.bias"] = _t(p["bias"])
            sd[f"{group}.{i}.style_kernel"] = _t(p["style_kernel"])
            sd[f"{group}.{i}.style_bias"] = _t(np.asarray(p["style_bias"]).reshape(1, -1))
    module = GoogleStylExGenerator(spec, device="cpu")
    module.load_state_dict(sd)
    return module.to(resolve_device(device))


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
