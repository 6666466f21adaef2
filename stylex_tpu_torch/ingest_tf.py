"""Google's published StylEx models and the counterfactual-FID protocol.

The counterfactual-FID protocol runs against Google's pretrained CelebA-age
StylEx, published as four TensorFlow SavedModels (``generator``,
``encoder``, ``discriminator`` and ``mobilenet``, each a
``<name>.savedmodel`` directory) and an ``examples_1.tfrecord`` of
precomputed dlatents and effects. This module runs that protocol from an
on-disk copy of those files:

* :class:`GoogleStylExTF` drives the loaded SavedModels with the notebook's
  literal semantics: the dlatent tiling, the style-vector calculator's
  StyleSpace, and the counterfactual as a mutation of the affine biases.
* :func:`convert_google_generator` lifts the generator's weights into the
  port's :class:`~stylex_tpu_torch.models.google_stylex.GoogleStylExGenerator`
  (the shift is an explicit ``style_delta``), adapting to the variable
  layouts a Keras restore produces; on a layout it cannot place it raises
  and points at :func:`describe_savedmodel`.
* :func:`load_examples_tfrecord` reads the examples file.
* :func:`google_fid_topk`: FID(original, generated), then FID(original,
  counterfactual top-1..k), through :mod:`stylex_tpu_torch.eval.fid`.

TensorFlow is needed to read a SavedModel, and is imported inside the
functions that do, with a clear ``ImportError`` where it is missing. A host
without it (the GPU machine, for one) loads a converted generator saved by
:func:`~stylex_tpu_torch.models.google_stylex.save_google_generator`.
:func:`load_examples_tfrecord` needs no TensorFlow: it parses the TFRecord
framing (with its CRC32C checks) and the ``tf.train.Example`` protobuf
itself.
"""

from __future__ import annotations

import csv
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stylex_tpu_torch.models.google_stylex import sindex_to_layer_and_index

__all__ = [
    "describe_savedmodel",
    "GoogleStylExTF",
    "convert_google_generator",
    "read_tfrecords",
    "parse_example",
    "load_examples_tfrecord",
    "google_fid_topk",
]


def _tf():
    try:
        import tensorflow as tf  # noqa: PLC0415

        return tf
    except ImportError as e:
        raise ImportError(
            "TensorFlow is required to read Google's StylEx SavedModels; install tensorflow, "
            "or convert on a host that has it and load the saved generator "
            "(models.google_stylex.save_google_generator / load_google_generator)"
        ) from e


def describe_savedmodel(path: str) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, dtype) of every variable of a SavedModel directory: the
    map for extending :func:`convert_google_generator` to a layout it does
    not place yet."""
    tf = _tf()
    reader = tf.train.load_checkpoint(str(Path(path) / "variables" / "variables"))
    shape_map = reader.get_variable_to_shape_map()
    dtype_map = reader.get_variable_to_dtype_map()
    return sorted((name, tuple(shape_map[name]), dtype_map[name].name)
                  for name in shape_map if not name.startswith("_CHECKPOINTABLE"))


def _call(fn, *args, **kwargs):
    """Call a restored function, with ``training=False`` where it takes it
    (Keras-restored callables do, plain ``tf.Module`` functions do not)."""
    try:
        return fn(*args, training=False, **kwargs)
    except TypeError:
        return fn(*args, **kwargs)


class GoogleStylExTF:
    """The protocol's SavedModels, driven with the notebook's semantics.

    Args:
      root: directory holding ``generator.savedmodel``,
        ``encoder.savedmodel``, ``discriminator.savedmodel`` and
        ``mobilenet.savedmodel``; missing ones are skipped (FID needs the
        generator and the classifier).
    """

    def __init__(self, root: str, num_layers: int = 14, label_size: int = 2):
        tf = _tf()
        root_p = Path(root)
        self.num_layers = num_layers
        self.label_size = label_size
        self.generator = self.encoder = self.discriminator = self.classifier = None
        for attr, name in (("generator", "generator.savedmodel"),
                           ("encoder", "encoder.savedmodel"),
                           ("discriminator", "discriminator.savedmodel"),
                           ("classifier", "mobilenet.savedmodel")):
            p = root_p / name
            if p.exists():
                setattr(self, attr, tf.saved_model.load(str(p)))
        if self.generator is None:
            raise FileNotFoundError(f"{root_p / 'generator.savedmodel'} not found")

    @property
    def layer_shapes(self) -> List[int]:
        """The style width of each conv block (the notebook's
        ``LAYER_SHAPES``)."""
        return [int(blk.dense_bias.weights[0].shape[1])
                for blk in self.generator.style_vector_calculator.style_dense_blocks]

    def sindex_to_layer_and_index(self, sindex: int) -> Tuple[int, int]:
        return sindex_to_layer_and_index(self.layer_shapes, sindex)

    def style_vectors(self, dlatents: np.ndarray) -> np.ndarray:
        """(B, total_style_coords) concatenated conv styles."""
        tf = _tf()
        blocks = _call(self.generator.style_vector_calculator,
                       tf.constant(dlatents, tf.float32))[0]
        return tf.concat(blocks, axis=1).numpy()

    def call_synthesis(self, dlatents: np.ndarray) -> np.ndarray:
        """Tiled (or untiled) dlatents -> NCHW image clipped to [-1, 1]."""
        tf = _tf()
        d = tf.constant(dlatents, tf.float32)
        if d.shape.rank == 2:
            d = tf.tile(tf.expand_dims(d, 1), [1, self.num_layers, 1])
        sv = _call(self.generator.style_vector_calculator, d[:, 0])
        out = _call(self.generator.g_synthesis, (sv[0], sv[1]))
        return tf.maximum(tf.minimum(out, 1), -1).numpy()

    def decode_latents(self, latents: np.ndarray, batch_size: int = 8) -> np.ndarray:
        """NHWC images of the dlatents."""
        return np.concatenate([np.transpose(self.call_synthesis(latents[s:s + batch_size]),
                                            (0, 2, 3, 1))
                               for s in range(0, len(latents), batch_size)])

    def classify(self, images_nhwc: np.ndarray) -> np.ndarray:
        tf = _tf()
        return np.asarray(_call(self.classifier, tf.constant(images_nhwc, tf.float32)))

    def encode(self, images_nchw: np.ndarray) -> np.ndarray:
        tf = _tf()
        return np.asarray(_call(self.encoder, tf.constant(images_nchw, tf.float32)))

    def counterfactual_images(self, latents: np.ndarray,
                              s_indices_and_signs: Sequence[Tuple[int, int]], k: int,
                              style_min: np.ndarray, style_max: np.ndarray,
                              shift_size: float = 1.0, batch_size: int = 8) -> np.ndarray:
        """The notebook's ``create_counterfactual_dataset``: the top-k shifts
        applied jointly per image by mutating the ``dense_bias`` weights,
        the direction flipped for images of base class 0. NHWC output."""
        tf = _tf()
        picks = list(s_indices_and_signs)[:k]
        blocks = self.generator.style_vector_calculator.style_dense_blocks
        layer_shapes = self.layer_shapes
        out = []
        for latent in latents:
            latent = latent[None]
            base_prob = self.classify(np.transpose(self.call_synthesis(latent), (0, 2, 3, 1)))
            flip = int(np.argmax(base_prob)) == 0
            applied = []
            for direction, sindex in picks:
                layer_idx, weight_idx = sindex_to_layer_and_index(layer_shapes, sindex)
                to_min = (direction == 0) != flip
                extreme = style_min[sindex] if to_min else style_max[sindex]
                # read again after each mutation, as the notebook does: the
                # shifts compound
                s_vals = self.style_vectors(latent)[0]
                shift = (extreme - s_vals[sindex]) * shift_size
                one_hot = shift * tf.expand_dims(tf.one_hot(weight_idx, layer_shapes[layer_idx]),
                                                 axis=0)
                blocks[layer_idx].dense_bias.weights[0].assign_add(one_hot)
                applied.append((layer_idx, one_hot))
            img = self.call_synthesis(latent)
            for layer_idx, one_hot in applied:
                blocks[layer_idx].dense_bias.weights[0].assign_add(-one_hot)
            out.append(np.transpose(img, (0, 2, 3, 1))[0])
        return np.stack(out)


# --------------------------------------------------------------- converter


def _var_np(obj, *path):
    """Walk an attribute / index path; the leaf as numpy, or None."""
    cur = obj
    for p in path:
        if isinstance(p, int):
            try:
                cur = cur[p]
            except (IndexError, KeyError, TypeError):
                return None
        else:
            cur = getattr(cur, p, None)
        if cur is None:
            return None
    try:
        return np.asarray(cur.numpy() if hasattr(cur, "numpy") else cur)
    except (TypeError, ValueError):
        return None


def _first(obj, *candidates):
    for path in candidates:
        v = _var_np(obj, *path)
        if v is not None:
            return v
    return None


def _locate_generator_parts(g):
    """``(style_vector_calculator, g_synthesis)`` of a restored generator,
    on the object or one level down (a Keras restore wraps the module under
    ``.model`` or the like). Raises, pointing at :func:`describe_savedmodel`,
    where neither carries both."""
    svc = getattr(g, "style_vector_calculator", None)
    syn = getattr(g, "g_synthesis", None)
    if svc is not None and syn is not None:
        return svc, syn
    for name in dir(g):
        if name.startswith("_"):
            continue
        try:
            child = getattr(g, name)
        except Exception:  # a restored object's property may raise anything
            continue
        csvc = getattr(child, "style_vector_calculator", None)
        csyn = getattr(child, "g_synthesis", None)
        if csvc is not None and csyn is not None:
            return csvc, csyn
    raise ValueError(
        "generator object lacks style_vector_calculator / g_synthesis attributes (checked the "
        "object and one level of nesting): run describe_savedmodel(path) to inspect the "
        "artifact's variable layout and extend convert_google_generator's candidate paths")


def _style_pair(blk, what: str):
    kern = _first(blk, ("dense", "kernel"), ("dense", "weights", 0))
    bias = _first(blk, ("dense_bias", "weights", 0), ("dense_bias", "bias"))
    if kern is None or bias is None:
        raise ValueError(f"{what}: could not locate dense.kernel / dense_bias.weights[0] "
                         f"(run describe_savedmodel to inspect)")
    return kern, bias.reshape(1, -1)


def _conv_pair(syn, group: str, i: int):
    weight = _first(syn, (group, i, "weight"), (group, i, "kernel"))
    bias = _first(syn, (group, i, "bias"))
    if weight is None or bias is None:
        raise ValueError(f"g_synthesis.{group}[{i}].weight/bias not found")
    return weight, bias


def convert_google_generator(tf_generator_or_path, device=None):
    """A Google-layout StylEx generator (a SavedModel directory or a
    restored object) -> ``(spec, module)``: the port's
    :class:`~stylex_tpu_torch.models.google_stylex.GoogleStylExSpec` and
    :class:`~stylex_tpu_torch.models.google_stylex.GoogleStylExGenerator` on
    ``device`` (the GPU unless ``'cpu'``).

    The layout read (attribute paths on the restored object), each with
    the Keras-restore alternatives:

    * ``style_vector_calculator.style_dense_blocks[i].dense.kernel`` (D, C_i)
      (or ``dense.weights[0]``) and ``.dense_bias.weights[0]`` (1, C_i) (or
      ``dense_bias.bias``); the same pair per ``torgb_dense_blocks[i]``;
    * ``g_synthesis.const`` (1, 4, 4, C4); ``g_synthesis.convs[i].weight``
      (3, 3, Cin, Cout) (or ``.kernel``) and ``.bias``; ``torgbs[i]`` the
      same with (1, 1, Cin, 3).

    The image size, dlatent width and channels come from the weights'
    shapes. Raises ``ValueError`` naming the first piece it cannot place.
    """
    from stylex_tpu_torch.models.convert import google_generator_from_jax
    from stylex_tpu_torch.models.google_stylex import GoogleStylExSpec

    if isinstance(tf_generator_or_path, (str, Path)):
        g = _tf().saved_model.load(str(tf_generator_or_path))
    else:
        g = tf_generator_or_path
    svc, syn = _locate_generator_parts(g)

    styles = [_style_pair(blk, f"style_dense_blocks[{i}]")
              for i, blk in enumerate(svc.style_dense_blocks)]
    const = _first(syn, ("const",))
    if const is None:
        raise ValueError("g_synthesis.const not found")
    convs = [_conv_pair(syn, "convs", i) for i in range(len(styles))]
    # conv 0 at 4 px, then two per higher resolution; the second's output
    # width is that resolution's
    channels, res = {4: int(convs[0][0].shape[3])}, 4
    for i in range(1, len(convs), 2):
        res *= 2
        channels[res] = int(convs[i + 1][0].shape[3])
    spec = GoogleStylExSpec(image_size=4 * 2 ** ((len(styles) - 1) // 2),
                            dlatent_dim=int(styles[0][0].shape[0]),
                            channels_map=tuple(sorted(channels.items())))
    want = [(3, 3, cin, cout) for (_, cin, cout) in spec.conv_specs]
    got = [tuple(w.shape) for w, _ in convs]
    if want != got:
        raise ValueError(f"conv weight shapes {got} do not form the expected "
                         f"1-then-2-per-resolution StyleGAN2 chain {want}; run "
                         f"describe_savedmodel and extend the converter")
    if spec.layer_shapes != [int(k.shape[1]) for k, _ in styles]:
        raise ValueError(f"style affine widths {[int(k.shape[1]) for k, _ in styles]} do not "
                         f"match the conv input channels {spec.layer_shapes}")
    torgb_blocks = list(getattr(svc, "torgb_dense_blocks", []))
    if len(torgb_blocks) < len(spec.torgb_specs):
        raise ValueError(f"style_vector_calculator.torgb_dense_blocks[{len(torgb_blocks)}] "
                         f"not found")
    tree = {"const": const, "convs": [], "torgbs": []}
    for (kern, bias), (weight, cbias) in zip(styles, convs):
        tree["convs"].append(dict(weight=weight, bias=cbias, style_kernel=kern,
                                  style_bias=bias))
    for i in range(len(spec.torgb_specs)):
        weight, bias = _conv_pair(syn, "torgbs", i)
        kern, sbias = _style_pair(torgb_blocks[i], f"torgb_dense_blocks[{i}]")
        tree["torgbs"].append(dict(weight=weight, bias=bias, style_kernel=kern,
                                   style_bias=sbias))
    module = google_generator_from_jax(tree, spec, device=device)
    return module.spec, module


# ------------------------------------------------------------------ records


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def _masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC32C (Castagnoli) of ``data``."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_tfrecords(path: str) -> Iterator[bytes]:
    """The records of a TFRecord file: each a little-endian uint64 length,
    its masked CRC32C, the data and its masked CRC32C. Raises
    ``ValueError`` on a truncated file or a checksum that does not match."""
    buf = Path(path).read_bytes()
    pos = 0
    while pos < len(buf):
        if len(buf) - pos < 12:
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        (length,) = struct.unpack_from("<Q", buf, pos)
        (length_crc,) = struct.unpack_from("<I", buf, pos + 8)
        start, end = pos + 12, pos + 12 + length
        if end + 4 > len(buf):
            raise ValueError(f"{path}: truncated record at byte {pos}")
        data = buf[start:end]
        (data_crc,) = struct.unpack_from("<I", buf, end)
        if _masked_crc32c(buf[pos:pos + 8]) != length_crc or _masked_crc32c(data) != data_crc:
            raise ValueError(f"{path}: CRC32C mismatch in the record at byte {pos}")
        yield data
        pos = end + 4


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message: an int for a
    varint, bytes for the other wire types."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value


def _feature(buf: bytes):
    """A ``tf.train.Feature``: a list of bytes, a float32 array or an int64
    array."""
    for number, _, lst in _fields(buf):
        if number == 1:  # BytesList
            return [v for n, _, v in _fields(lst) if n == 1]
        if number == 2:  # FloatList: packed, or one float per field
            parts = [np.frombuffer(v, "<f4") for n, _, v in _fields(lst) if n == 1]
            return np.concatenate(parts) if parts else np.zeros(0, np.float32)
        if number == 3:  # Int64List: packed varints, or one per field
            vals = []
            for n, wire, v in _fields(lst):
                if n != 1:
                    continue
                if wire == 0:
                    vals.append(v)
                else:
                    pos = 0
                    while pos < len(v):
                        x, pos = _varint(v, pos)
                        vals.append(x)
            return np.array(vals, np.uint64).astype(np.int64)
    return None


def parse_example(data: bytes) -> Dict[str, object]:
    """A serialised ``tf.train.Example`` -> feature name -> value (see
    :func:`_feature`)."""
    out: Dict[str, object] = {}
    for number, _, features in _fields(data):
        if number != 1:
            continue
        for n, _, entry in _fields(features):
            if n != 1:
                continue
            key, value = "", b""
            for m, _, v in _fields(entry):
                if m == 1:
                    key = v.decode()
                elif m == 2:
                    value = v
            out[key] = _feature(value)
    return out


def load_examples_tfrecord(path: str, num_classes: int = 2):
    """``examples_1.tfrecord`` -> (latents (N, D), style_change_effect
    (N, 2, C, classes), base_probs (N, classes)), float64 as the notebook's
    parse gives them. No TensorFlow needed."""
    latents, effects, base_probs = [], [], []
    for raw in read_tfrecords(path):
        f = parse_example(raw)
        latents.append(f["dlatent"].astype(np.float64))
        effect = f["result"].astype(np.float64).reshape((-1, 2, num_classes))
        effects.append(effect.transpose([1, 0, 2]))
        base_probs.append(f["base_prob"].astype(np.float64))
    return np.array(latents), np.array(effects), np.array(base_probs)


# ---------------------------------------------------------------- protocol


def google_fid_topk(models, original_images: np.ndarray, latents: np.ndarray,
                    s_indices_and_signs: Sequence[Tuple[int, int]], k: int = 10,
                    shift_size: float = 1.0, batch_size: int = 8, feature_fn=None,
                    csv_path: Optional[str] = None, generator=None) -> List[float]:
    """``FID(original, generated)``, then ``FID(original, counterfactual
    top-1..i)`` for i = 1..k.

    Args:
      models: any object with ``style_vectors(dlatents) -> (B, C)`` and
        ``classify(NHWC images in [-1, 1]) -> logits`` on numpy arrays
        (:class:`GoogleStylExTF`, or a stand-in); without ``generator`` also
        ``call_synthesis`` and ``counterfactual_images``.
      original_images: (N, H, W, 3) in [0, 1].
      latents: (N, dlatent_dim) dlatents (e.g. of
        :func:`load_examples_tfrecord`).
      generator: ``(spec, module)`` of :func:`convert_google_generator`.
        The images then come from the port's generator on the module's
        device, float32 with TF32 off: the base images and the class flips
        once, then each top-i set as one batched forward per batch with the
        joint ``style_delta``. Without it, from ``models``' TensorFlow
        mutation loop.
      feature_fn: the FID features; by default
        :func:`~stylex_tpu_torch.eval.fid.resolve_feature_fn`'s, on the
        module's device.

    Returns the k + 1 FIDs; writes ``fid_results.csv`` to ``csv_path`` when
    given.
    """
    from stylex_tpu_torch.eval.fid import (
        compute_feature_stats,
        frechet_distance,
        resolve_feature_fn,
    )

    module = generator[1] if generator is not None else None
    device = next(module.parameters()).device if module is not None else None
    feature_fn = resolve_feature_fn(feature_fn, device)
    style_vecs = models.style_vectors(latents)
    style_min, style_max = style_vecs.min(0), style_vecs.max(0)

    def batches(arr):
        for s in range(0, len(arr), batch_size):
            yield arr[s:s + batch_size]

    def stats(images):  # (N, H, W, 3) in [0, 1]
        return compute_feature_stats(batches(images), feature_fn)

    def to01(x):
        return np.clip((x + 1.0) / 2.0, 0.0, 1.0)

    if module is not None:
        from stylex_tpu_torch.device import set_float32_precision

        set_float32_precision()
        C = module.total_style_coords

        @torch.no_grad()
        def synth(w: np.ndarray, delta: np.ndarray) -> np.ndarray:
            img = module.call_synthesis(torch.as_tensor(w, dtype=torch.float32, device=device),
                                        torch.as_tensor(delta, device=device))
            return img.permute(0, 2, 3, 1).float().cpu().numpy()

        base_imgs = np.concatenate([synth(w, np.zeros((len(w), C), np.float32))
                                    for w in batches(latents)])
        flips = np.concatenate([np.argmax(models.classify(img), axis=-1) == 0
                                for img in batches(base_imgs)])

        def cf_dataset(i):
            if i == 0:
                return base_imgs
            picks = list(s_indices_and_signs)[:i]
            imgs = []
            for s in range(0, len(latents), batch_size):
                w, sv = latents[s:s + batch_size], style_vecs[s:s + batch_size]
                delta = np.zeros((len(w), C), np.float32)
                for bi in range(len(w)):
                    flip = bool(flips[s + bi])
                    for direction, sindex in picks:
                        to_min = (direction == 0) != flip
                        extreme = style_min[sindex] if to_min else style_max[sindex]
                        delta[bi, sindex] = (extreme - sv[bi, sindex]) * shift_size
                imgs.append(synth(w, delta))
            return np.concatenate(imgs)
    else:
        def cf_dataset(i):
            if i == 0:
                return np.transpose(np.concatenate([models.call_synthesis(b)
                                                    for b in batches(latents)]), (0, 2, 3, 1))
            return models.counterfactual_images(latents, s_indices_and_signs, i, style_min,
                                                style_max, shift_size, batch_size)

    mu_o, cov_o = stats(original_images)
    fids = []
    for i in range(k + 1):
        mu, cov = stats(to01(cf_dataset(i)))
        fids.append(frechet_distance(mu_o, cov_o, mu, cov))
    if csv_path:
        Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["k", "fid"])
            w.writerow(["generated", fids[0]])
            for i, fid in enumerate(fids[1:], 1):
                w.writerow([i, fid])
    return fids
