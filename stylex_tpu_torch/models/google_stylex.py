"""Google's StylEx generator (the published pretrained models), NCHW.

The counterfactual-FID protocol runs against Google's pretrained CelebA-age
StylEx, a StyleGAN2-skip generator in its own layout. It splits into

* a style-vector calculator: per-conv affines ``s_i = w @ K_i + b_i`` of the
  514-d dlatent (512 + 2 condition dims), whose concatenation is the
  StyleSpace that AttFind perturbs, plus separate to-RGB affines;
* a synthesis network that takes the style lists and produces an image in
  [-1, 1] (``call_synthesis`` clips); the dlatent is tiled over
  ``num_layers`` slots, but only slot 0 feeds the calculator.

:class:`GoogleStylExSpec` holds the structure (resolutions 4..S, one 3x3
conv at 4 px then an up-conv and a conv per higher resolution, a to-RGB
skip per resolution: 13 convs and 7 to-RGBs at 256 px), and
:class:`GoogleStylExGenerator` the weights and the forward. The StyleSpace
shift is an explicit ``style_delta`` input, as in the JAX package, where
the notebook mutates the affine biases. The forward is built on the port's
:func:`~stylex_tpu_torch.ops.modconv.modulated_conv2d`,
:func:`~stylex_tpu_torch.ops.modconv.modulated_upsample_conv2d` and
:func:`~stylex_tpu_torch.ops.blur.upsample2x_bilinear`, which launch the
package's upsample kernel on CUDA tensors: on the RGB skip at every
resolution, and at the block entries in the fused graph's border strips or
the literal graph's upsample, chosen per call by
:func:`~stylex_tpu_torch.ops.fusion.resample_fusion_enabled` as the JAX
package does. The style affines are plain matrix products. Synthesis
resumes at a resolution from that resolution's cached entry state, as the
StylEx generator resumes at a block, and it offers the StylEx bundle's
``sweep_phase1``, ``sweep_images``, ``block_sizes`` and
``block_resolutions`` (no D, so no filter and no ``sweep_states``), so the
AttFind sweep runs this generator too
(:func:`~stylex_tpu_torch.attfind.extraction.attfind_extraction` from
dlatents).

Weights come from :func:`stylex_tpu_torch.ingest_tf.convert_google_generator`
(a TensorFlow SavedModel), from the JAX package's tree through
:func:`stylex_tpu_torch.models.convert.google_generator_from_jax`, from a
file of :func:`save_google_generator`, or from a seeded init.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stylex_tpu_torch.device import resolve_device
from stylex_tpu_torch.ops.blur import upsample2x_bilinear
from stylex_tpu_torch.ops.fusion import resample_fusion_enabled
from stylex_tpu_torch.ops.modconv import modulated_conv2d, modulated_upsample_conv2d

State = Tuple[torch.Tensor, Optional[torch.Tensor]]

__all__ = [
    "GoogleStylExSpec",
    "GoogleStylExGenerator",
    "google_channels",
    "sindex_to_layer_and_index",
    "save_google_generator",
    "load_google_generator",
]


def sindex_to_layer_and_index(layer_shapes: Sequence[int], sindex: int) -> Tuple[int, int]:
    """Flat StyleSpace index -> (layer, index within the layer), given the
    per-layer style widths (the notebook's ``LAYER_SHAPES``)."""
    cum = np.concatenate([[0], np.cumsum(layer_shapes)])
    if not 0 <= sindex < cum[-1]:
        raise IndexError(f"sindex {sindex} outside StyleSpace [0, {int(cum[-1])})")
    layer = int(np.flatnonzero(cum <= sindex)[-1])
    return layer, int(sindex - cum[layer])


def google_channels(image_size: int, fmap_base: int = 8192, fmap_max: int = 512,
                    fmap_min: int = 1) -> Dict[int, int]:
    """StyleGAN2's ``nf()`` channel schedule per resolution."""
    return {2 ** r: int(min(max(fmap_base // (2 ** (r - 1)), fmap_min), fmap_max))
            for r in range(2, int(math.log2(image_size)) + 1)}


@dataclasses.dataclass(frozen=True)
class GoogleStylExSpec:
    """The generator's structure. ``channels_map`` ((resolution, channels),
    ...) overrides the ``fmap_base`` schedule, as the converters set it from
    the weights' shapes."""

    image_size: int = 256
    dlatent_dim: int = 514
    fmap_base: int = 8192
    fmap_max: int = 512
    channels_map: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def channels(self) -> Dict[int, int]:
        if self.channels_map is not None:
            return dict(self.channels_map)
        return google_channels(self.image_size, self.fmap_base, self.fmap_max)

    @property
    def resolutions(self) -> List[int]:
        return sorted(self.channels)

    @property
    def num_layers(self) -> int:
        """dlatent tiling slots: 2 * log2(S) - 2 (14 at 256 px)."""
        return 2 * int(math.log2(self.image_size)) - 2

    @property
    def conv_specs(self) -> List[Tuple[int, int, int]]:
        """(resolution, in_ch, out_ch) per 3x3 conv, in synthesis order."""
        ch = self.channels
        specs, prev = [(4, ch[4], ch[4])], ch[4]
        for res in self.resolutions[1:]:
            specs += [(res, prev, ch[res]), (res, ch[res], ch[res])]
            prev = ch[res]
        return specs

    @property
    def torgb_specs(self) -> List[Tuple[int, int]]:
        """(resolution, in_ch) per to-RGB layer."""
        return [(res, self.channels[res]) for res in self.resolutions]

    @property
    def layer_shapes(self) -> List[int]:
        """The style width of each conv (its input channels)."""
        return [cin for (_, cin, _) in self.conv_specs]

    @property
    def total_style_coords(self) -> int:
        return sum(self.layer_shapes)

    @property
    def block_sizes(self) -> List[int]:
        """StyleSpace coordinates per synthesis block, one block a
        resolution: 512, 1,024, 1,024, 1,024, 768, 384, 192 at 256 px."""
        per = {res: 0 for res in self.resolutions}
        for res, cin, _ in self.conv_specs:
            per[res] += cin
        return [per[res] for res in self.resolutions]

    def sindex_to_layer_and_index(self, sindex: int) -> Tuple[int, int]:
        return sindex_to_layer_and_index(self.layer_shapes, sindex)


class _StyledConv(nn.Module):
    """A modulated conv's weight (OIHW) and bias, and its style affine
    ``w @ style_kernel + style_bias``."""

    def __init__(self, cin: int, cout: int, k: int, dlatent_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.style_kernel = nn.Parameter(torch.empty(dlatent_dim, cin))
        self.style_bias = nn.Parameter(torch.ones(1, cin))

    def style(self, w: torch.Tensor) -> torch.Tensor:
        return w @ self.style_kernel.to(w.dtype) + self.style_bias.to(w.dtype)


def _to_unit(img: torch.Tensor) -> torch.Tensor:
    """An image clipped to [-1, 1], mapped to the classifier's [0, 1]."""
    return (img.clamp(-1.0, 1.0) + 1.0) / 2.0


class GoogleStylExGenerator(nn.Module):
    """The generator of ``spec``, with weights from ``seed`` (the JAX
    package's init distributions, drawn on the host from a
    ``torch.Generator``), placed on ``device``: the GPU unless ``'cpu'``.
    Parameters are float32 unless cast; the forward runs in the dlatent's
    dtype."""

    has_discriminator = False

    def __init__(self, spec: Optional[GoogleStylExSpec] = None, seed: int = 0, device=None):
        super().__init__()
        spec = spec or GoogleStylExSpec()
        self.spec = spec
        d = spec.dlatent_dim
        self.const = nn.Parameter(torch.empty(1, spec.channels[4], 4, 4))
        self.convs = nn.ModuleList(_StyledConv(cin, cout, 3, d) for _, cin, cout in spec.conv_specs)
        self.torgbs = nn.ModuleList(_StyledConv(cin, 3, 1, d) for _, cin in spec.torgb_specs)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            self.const.copy_(torch.randn(self.const.shape, generator=gen) * 0.1)
            for layer in list(self.convs) + list(self.torgbs):
                cin, k = layer.weight.shape[1], layer.weight.shape[2]
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen)
                                   / math.sqrt(k * k * cin))
                layer.style_kernel.copy_(torch.randn(layer.style_kernel.shape, generator=gen)
                                         / math.sqrt(d))
        self.to(resolve_device(device))

    @property
    def total_style_coords(self) -> int:
        return self.spec.total_style_coords

    @property
    def block_sizes(self) -> List[int]:
        return self.spec.block_sizes

    @property
    def block_resolutions(self) -> List[int]:
        return self.spec.resolutions

    def sweep_phase1(self, w, classify, noise, capture: bool):
        """AttFind's phase 1 of (B, dlatent_dim) dlatents (``noise`` unused:
        the generator takes none). Returns ``(w, coords, d, base_logits,
        states, images)``: the style vectors concatenated, no D (NaN), the
        logits of the base image clipped and mapped to [0, 1], the
        resolution-entry states, and that image NHWC."""
        coords = torch.cat(self.style_vectors(w)[0], dim=-1)
        out = self.synthesize(w, capture_states=capture)
        img, states = out if capture else (out, None)
        img = _to_unit(img)
        d = torch.full((w.shape[0],), float("nan"), dtype=w.dtype, device=w.device)
        return w, coords, d, classify(img), states, img.permute(0, 2, 3, 1)

    def sweep_images(self, w, noise, style_delta, start_block: int = 0, initial_state=None):
        """The images the classifier scores for perturbed styles, clipped
        and mapped to [0, 1], resumed at ``start_block`` from
        ``initial_state``."""
        return _to_unit(self.synthesize(w, style_delta, start_block, initial_state))

    def style_vectors(self, w: torch.Tensor):
        """The per-conv and per-to-RGB style lists of a (B, dlatent_dim)
        dlatent."""
        return [c.style(w) for c in self.convs], [t.style(w) for t in self.torgbs]

    def synthesize(self, w: torch.Tensor, style_delta: Optional[torch.Tensor] = None,
                   start_block: int = 0, initial_state: Optional[State] = None,
                   capture_states: bool = False):
        """(B, dlatent_dim) dlatent -> (B, 3, S, S) image, not clipped.

        ``style_delta`` (B, total_style_coords) adds to the concatenated
        conv styles: the notebook's bias mutation as an input.

        A block is one resolution: the 4-px conv, or a higher resolution's
        up-conv and conv, then that resolution's to-RGB. Its entry state
        is ``(x, rgb)``, the previous resolution's features and image before
        their upsample (the constant and None at 4 px). A perturbation in
        block k changes nothing upstream of it, so a sweep resumes at
        ``start_block`` k from the cached ``initial_state``, as
        :meth:`~stylex_tpu_torch.models.generator.Generator.forward` does;
        only the styles of blocks k.. are computed. ``capture_states``
        returns ``(image, states)``, every run block's entry state."""
        spec = self.spec
        if initial_state is not None:
            x, rgb = initial_state
        elif start_block == 0:
            x, rgb = self.const.to(w.dtype).expand(w.shape[0], -1, -1, -1), None
        else:
            raise ValueError("start_block > 0 requires initial_state=(x, rgb)")
        offsets = np.cumsum([0] + spec.layer_shapes).tolist()
        states = []
        i = 0 if start_block == 0 else 2 * start_block - 1  # the block's first conv
        for b in range(start_block, len(spec.resolutions)):
            if capture_states:
                states.append((x, rgb))
            for k in range(1 if b == 0 else 2):
                conv = self.convs[i]
                style = conv.style(w)
                if style_delta is not None:
                    style = style + style_delta[:, offsets[i]:offsets[i + 1]].to(w.dtype)
                # the affine output modulates directly; modulated_conv2d adds 1
                style = style - 1.0
                weight = conv.weight.to(x.dtype)
                if b != 0 and k == 0:
                    if weight.shape[2:] == (3, 3) and x.shape[2] >= 2 and \
                            resample_fusion_enabled():
                        x = modulated_upsample_conv2d(x, weight, style, demod=True)
                    else:
                        x = modulated_conv2d(upsample2x_bilinear(x), weight, style, demod=True)
                else:
                    x = modulated_conv2d(x, weight, style, demod=True)
                x = F.leaky_relu(x + conv.bias.to(x.dtype)[None, :, None, None], 0.2)
                i += 1
            t = self.torgbs[b]
            y = modulated_conv2d(x, t.weight.to(x.dtype), t.style(w) - 1.0, demod=False)
            y = y + t.bias.to(y.dtype)[None, :, None, None]
            rgb = y if rgb is None else upsample2x_bilinear(rgb) + y
        return (rgb, states) if capture_states else rgb

    def call_synthesis(self, dlatents: torch.Tensor,
                       style_delta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The notebook's ``call_synthesis``: tiled (B, num_layers,
        dlatent_dim) dlatents (or (B, dlatent_dim)), slot 0, the image
        clipped to [-1, 1]."""
        w = dlatents[:, 0] if dlatents.dim() == 3 else dlatents
        return self.synthesize(w, style_delta).clamp(-1.0, 1.0)


def save_google_generator(path: str, spec: GoogleStylExSpec,
                          module: GoogleStylExGenerator) -> str:
    """Write the generator as a ``.pt`` (its spec and state dict), to move a
    converted model to a host without TensorFlow."""
    torch.save({"spec": dataclasses.asdict(spec),
                "state_dict": {k: v.detach().cpu() for k, v in module.state_dict().items()}},
               path)
    return str(path)


def load_google_generator(path: str, device=None) -> Tuple[GoogleStylExSpec,
                                                           GoogleStylExGenerator]:
    """``(spec, module)`` of a :func:`save_google_generator` file, on
    ``device`` (the GPU unless ``'cpu'``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    d = payload["spec"]
    if d.get("channels_map") is not None:
        d["channels_map"] = tuple(tuple(p) for p in d["channels_map"])
    spec = GoogleStylExSpec(**d)
    module = GoogleStylExGenerator(spec, device="cpu")
    module.load_state_dict(payload["state_dict"])
    return spec, module.to(resolve_device(device))
