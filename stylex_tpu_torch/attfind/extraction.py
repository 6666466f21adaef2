"""AttFind extraction: the StyleSpace attribute search.

The reference walks image x style coordinate x direction one perturbation
at a time, mutating ``to_style{1,2}.bias`` and running a batch-1 generator
and classifier forward for each. The mutation is an additive delta on the
style activations, so here the sweep is a batch: chunks of ``coord_batch``
perturbations, each a generator forward with a (chunk, num_coords) one-hot
``style_delta`` followed by one classifier forward. Every chunk element is
addressed by (image, coordinate, direction) indices; the shift
``(extreme - current) * shift_size`` and the one-hot delta are built on the
device.

Two sweeps give the same records:

* block-resume (the default): perturbations are grouped by generator
  block, and synthesis restarts at that block from each image's cached
  block-entry state, so upstream blocks are never recomputed; each block's
  states are freed once its group is done;
* flat: every perturbation runs the whole generator.

The loop asks the model for its ``block_sizes`` and ``block_resolutions``,
its phase 1 (``sweep_phase1``), the images of perturbed styles
(``sweep_images``) and, after a D filter (``has_discriminator``), its
block-entry states (``sweep_states``). The StylEx bundle
offers them, and so does Google's published generator
(:class:`~stylex_tpu_torch.models.google_stylex.GoogleStylExGenerator`),
swept from dlatents: a block is then one resolution, phase 1 is the style
vectors, the base image clipped to [-1, 1] and the classifier's logits of
it mapped to [0, 1], and there is no encoder and no D. The extremes of each
coordinate come from the call's own inputs or, with ``style_range``, from a
larger pool (the notebook takes them over every dlatent it has).

Chunks are issued back to back with no host read between them, and their
outputs stay on the device: every ``chunks_per_dispatch`` chunks share one
device-to-host copy of their concatenated effects, into pinned memory and
without blocking; the host waits for the copies once, at the end of each
sweep. The chunks, and so the records, are the same for every
``chunks_per_dispatch``.

The whole extraction runs inside ``prefer_literal_resample()``: the
generator's and D/E's literal resample graph (bilinear upsample, blur),
through the package's CUDA kernels on the GPU, as the JAX package's sweep
does (it measured faster there for forward-only sweeps). An explicit
``STYLEX_TPU_NO_FUSED_UPCONV`` still wins.

With a ``mesh`` of several ranks (:mod:`stylex_tpu_torch.parallel`) every
rank runs phase 1 and the discriminator filter on every image, keeping rank
0's results (broadcast), and takes its slice of each chunk of
perturbations; ``coord_batch`` is rounded up to a multiple of the world
size, a short last chunk is padded, and each copy group's effects are
gathered once, so that every rank returns the same records, those of one
process.

The host's work is in spans of :mod:`stylex_tpu_torch.utils.tracing`:
``attfind.call`` holds ``attfind.phase1``, ``attfind.capture``, one
``attfind.block`` per generator block (unit: the block; attributes ``res``,
its resolution in pixels, and ``styles``, its perturbations) with an
``attfind.chunk`` per chunk issued and an ``attfind.copy`` per group's
copy, and ``attfind.records``; ``attfind.wait`` is each synchronise, the
sweep's closing one and each stage's end. The counter ``attfind.styles``
adds each chunk's perturbations.

The records keep the JAX package's layout (NHWC images, the same shapes)
and the reference's ``style_change_records.hdf5`` schema. Where h5py is
not installed they go to ``.npz`` with the same datasets:
:func:`save_records` and :func:`load_records` choose by the file's suffix,
:func:`records_file_name` by whether h5py imports.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from stylex_tpu_torch.device import resolve_dtype, set_float32_precision, to_host_async
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.ops.fusion import prefer_literal_resample
from stylex_tpu_torch.parallel.mesh import Mesh, coordinate_sharding, gather, replicated
from stylex_tpu_torch.utils import tracing

__all__ = [
    "AttFindRecords",
    "attfind_extraction",
    "find_discriminator_threshold",
    "save_records_hdf5",
    "load_records_hdf5",
    "save_records",
    "load_records",
    "records_file_name",
]

Classify = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class AttFindRecords:
    """In-memory mirror of ``style_change_records.hdf5``."""

    style_change: np.ndarray  # (N, 2, C, num_classes): [image, direction(min/max), sindex, class]
    latents: np.ndarray  # (N, latent_dim): w, or Google's dlatents
    base_prob: np.ndarray  # (N, num_classes) classifier logits of the base generated image
    minima: np.ndarray  # (C,)
    maxima: np.ndarray  # (C,)
    style_coordinates: np.ndarray  # (N, C)
    original_images: np.ndarray  # (N, S, S, 3) in [0, 1]: the inputs, or Google's base images
    noise: np.ndarray  # (1, S, S, 1); zeros for Google's generator, which takes none
    discriminator: np.ndarray  # (N, 1); NaN for Google's generator: no D ran
    # seconds from the start of the extraction to the end of each stage
    # (not written to the hdf5: the reference schema has no such dataset)
    stage_walls: Optional[Dict[str, float]] = None


def _cat_states(parts: List[list]) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Per-batch lists of per-block (x, rgb) -> per-block batch-concatenated."""
    return [
        (torch.cat([p[k][0] for p in parts]),
         None if parts[0][k][1] is None else torch.cat([p[k][1] for p in parts]))
        for k in range(len(parts[0]))
    ]


def _capture_states(model, w_all, noise, batch: int):
    """Block-entry states of every image, one generator forward per batch
    (after the D filter)."""
    return _cat_states([model.sweep_states(w_all[start:start + batch], noise)
                        for start in range(0, w_all.shape[0], batch)])


def _sweep_chunk(model, classify: Classify, w_all, noise, coords_all, minima,
                 maxima, base_all, img_idx, coord_idx, is_max, shift_size: float,
                 start_block: int = 0, states=None):
    """Classifier logit changes of one chunk of perturbations."""
    extreme = torch.where(is_max, maxima[coord_idx], minima[coord_idx])
    shift = (extreme - coords_all[img_idx, coord_idx]) * shift_size
    deltas = torch.zeros(coord_idx.shape[0], model.total_style_coords,
                         dtype=w_all.dtype, device=w_all.device)
    deltas.scatter_(1, coord_idx[:, None], shift[:, None])
    initial_state = None
    if states is not None:
        x_st, rgb_st = states
        initial_state = (x_st[img_idx], None if rgb_st is None else rgb_st[img_idx])
    images = model.sweep_images(w_all[img_idx], noise, deltas, start_block, initial_state)
    return classify(images) - base_all[img_idx]


def _sweep_ids(n_images: int, offset: int, size: int, device):
    """(image, coordinate, is_max) of every perturbation, in
    (image, direction, coordinate) order, so the effects reshape straight
    into style_change's (N, 2, size) layout."""
    img = torch.arange(n_images, device=device).repeat_interleave(2 * size)
    is_max = torch.tensor([False, True], device=device).repeat_interleave(size).repeat(n_images)
    coord = torch.arange(offset, offset + size, device=device).repeat(2 * n_images)
    return img, coord, is_max


def _gather_chunks(local: torch.Tensor, sizes: List[int], mesh: Mesh) -> torch.Tensor:
    """Every rank's effects of a group of chunks (this rank's are ``local``:
    ``ceil(n / W)`` rows per chunk of ``n`` in ``sizes``, in chunk order) ->
    the chunks' effects in perturbation order, padding dropped."""
    per = [math.ceil(n / mesh.world_size) for n in sizes]
    ranks = gather(local, mesh).reshape(mesh.world_size, sum(per), -1)
    return torch.cat([part.reshape(mesh.world_size * p, -1)[:n]
                      for part, p, n in zip(ranks.split(per, dim=1), per, sizes)])


def _to_device(inputs: np.ndarray, device, dtype) -> torch.Tensor:
    """A batch of the sweep's inputs on the device: NHWC images as NCHW,
    dlatents as they are."""
    if inputs.ndim == 4:
        inputs = np.ascontiguousarray(inputs.transpose(0, 3, 1, 2))
    return torch.from_numpy(inputs).to(device, dtype)


def _wait(device, sync: Callable) -> None:
    """``sync(device)`` on a GPU, as an ``attfind.wait`` span."""
    if device.type == "cuda":
        with tracing.span("attfind.wait"):
            sync(device)


def _call_span(fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with tracing.span("attfind.call"):
            return fn(*args, **kwargs)

    return call


@_call_span
@torch.no_grad()
@prefer_literal_resample()
def attfind_extraction(
    model,
    classifier_fn: Classify,
    images: np.ndarray,
    noise: Optional[np.ndarray] = None,
    shift_size: float = 1.0,
    discriminator_threshold: Optional[float] = None,
    use_discriminator: bool = False,
    coord_batch: int = 512,
    phase1_batch: int = 64,
    progress: bool = True,
    block_resume: bool = True,
    num_images: Optional[int] = None,
    compute_dtype=None,
    chunks_per_dispatch: int = 8,
    mesh: Optional[Mesh] = None,
    style_range: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> AttFindRecords:
    """Run the full AttFind extraction over a set of images.

    It runs on the device that holds ``model``.

    Args:
      model: the StylEx bundle or Google's generator (swept from
        dlatents), its weights in ``compute_dtype``.
      classifier_fn: (B, 3, S, S) images in [0, 1] -> (B, num_classes)
        logits, e.g. ``ClassifierBundle.classify_images`` with its weights
        in ``compute_dtype``.
      images: (P, S, S, 3) candidate images in [0, 1], NHWC; for Google's
        generator (P, dlatent_dim) dlatents. With ``use_discriminator``,
        pass more than ``num_images``: the first ``num_images`` survivors
        are kept.
      noise: (1, S, S, 1) fixed noise image shared by every forward; None
        for Google's generator, which takes none.
      shift_size: multiplier on the (extreme - current) shifts.
      discriminator_threshold: keep images whose D score is below it.
      coord_batch: perturbations per chunk.
      phase1_batch: images per phase-1 forward.
      block_resume: resume synthesis at the perturbed block from cached
        per-image block states (same records as the flat sweep).
      num_images: cap on the images that enter the sweep, after the filter.
      compute_dtype: float32 (default) or bfloat16. Records are float32.
      chunks_per_dispatch: chunks whose effects share one device-to-host
        copy; the records do not depend on it.
      mesh: a data-parallel mesh whose ranks split each chunk (every rank
        calls with the same arguments and gets the same records); None or
        a mesh without a process group: one process.
      style_range: (C,) minima and maxima of every coordinate, e.g. over a
        pool of dlatents; by default those of the images that enter the
        sweep.

    Returns:
      :class:`AttFindRecords`; ``stage_walls`` holds the time at the end of
      each stage (the device is synchronised at each stage's end).
    """
    dtype = resolve_dtype(compute_dtype)
    param = next(model.parameters())
    if param.dtype != dtype:
        raise ValueError(f"model weights are {param.dtype}, compute dtype is {dtype}: "
                         "cast the model (and classifier) with .to(dtype) first")
    if use_discriminator and not model.has_discriminator:
        raise ValueError(f"{type(model).__name__} comes without a discriminator to filter by")
    device = param.device
    if dtype == torch.float32:
        set_float32_precision()
    t0 = time.perf_counter()
    stage_walls: Dict[str, float] = {}

    def mark(tag: str) -> None:
        _wait(device, torch.cuda.synchronize)
        stage_walls[tag] = time.perf_counter() - t0
        if progress:
            print(f"attfind[{tag}] +{stage_walls[tag]:.1f}s", flush=True)

    if mesh is not None and mesh.group is None:
        mesh = None
    if mesh is not None:
        coord_batch = math.ceil(coord_batch / mesh.world_size) * mesh.world_size
    images = np.asarray(images, np.float32)
    P = images.shape[0]
    noise_t = None if noise is None else torch.from_numpy(
        np.asarray(noise, np.float32)).to(device, dtype)
    use_filter = use_discriminator and discriminator_threshold is not None
    capture = block_resume and not use_filter

    # ---- phase 1: batched over images
    with tracing.span("attfind.phase1"):
        parts = []
        for start in range(0, P, phase1_batch):
            chunk = _to_device(images[start:start + phase1_batch], device, dtype)
            parts.append(model.sweep_phase1(chunk, classifier_fn, noise_t, capture))
        w_all, coords_all, d_all, base_all = (torch.cat([p[i] for p in parts]) for i in range(4))
        states = _cat_states([p[4] for p in parts]) if capture else None
        # the model's own base images, where its inputs are no images
        shown = None if parts[0][5] is None else torch.cat([p[5] for p in parts])
        del parts
        if mesh is not None:  # rank 0's phase 1: the filter and records agree
            replicated(mesh, [w_all, coords_all, d_all, base_all])
    mark("phase1")

    keep = np.arange(P)
    if use_filter:
        keep = np.flatnonzero(d_all.float().cpu().numpy() < discriminator_threshold)
        if keep.size == 0:
            raise ValueError("No images pass the threshold check")
    if num_images is not None:
        if keep.size < num_images:
            print(f"attfind: only {keep.size} of the requested {num_images} images "
                  f"survive the discriminator filter; pass a larger candidate pool")
        keep = keep[:num_images]
    N = int(keep.size)
    if use_filter:
        idx = torch.from_numpy(keep).to(device)
        w_all, coords_all, d_all, base_all = (t[idx] for t in (w_all, coords_all, d_all, base_all))
        mark("discriminator_filter")
    else:
        w_all, coords_all, d_all, base_all = (t[:N] for t in (w_all, coords_all, d_all, base_all))
    if style_range is None:  # elementwise min/max over the images that enter the sweep
        minima = coords_all.min(dim=0).values
        maxima = coords_all.max(dim=0).values
    else:
        minima, maxima = (torch.as_tensor(np.asarray(r, np.float32)).to(device, dtype)
                          for r in style_range)

    K = max(1, int(chunks_per_dispatch))

    def run_sweep(total, ids, start_block=0, block_states=None):
        img, coord, is_max = ids
        group, sizes, host = [], [], []
        for s in range(0, total, coord_batch):
            rows = slice(s, s + coord_batch)
            n = min(coord_batch, total - s)
            issued = n
            if mesh is not None:  # this rank's share, the last id repeated as padding
                part = coordinate_sharding(mesh, n)
                rows = torch.arange(part.start, part.stop, device=device).clamp(max=n - 1) + s
                issued = max(0, min(part.stop, n) - part.start)
                sizes.append(n)
            with tracing.span("attfind.chunk"):
                group.append(_sweep_chunk(
                    model, classifier_fn, w_all, noise_t, coords_all, minima, maxima, base_all,
                    img[rows], coord[rows], is_max[rows], shift_size, start_block, block_states))
            tracing.count("attfind.styles", issued)
            if len(group) == K or s + coord_batch >= total:
                with tracing.span("attfind.copy"):
                    effects = torch.cat(group).float()
                    if mesh is not None:
                        effects = _gather_chunks(effects, sizes, mesh)
                    host.append(to_host_async(effects))
                group, sizes = [], []
        _wait(device, lambda d: torch.cuda.current_stream(d).synchronize())
        return torch.cat(host).numpy()

    C = model.total_style_coords
    if block_resume:
        with tracing.span("attfind.capture"):
            if states is None:
                states = _capture_states(model, w_all, noise_t, phase1_batch)
            else:
                states = [(x[:N], None if rgb is None else rgb[:N]) for x, rgb in states]
            if mesh is not None:
                replicated(mesh, states)
        mark("capture_states")
        per_block = []
        offset = 0
        for k, (size, res) in enumerate(zip(model.block_sizes, model.block_resolutions)):
            with tracing.span("attfind.block", unit=k, res=res, styles=N * 2 * size):
                eff = run_sweep(N * 2 * size, _sweep_ids(N, offset, size, device), k, states[k])
                per_block.append(eff.reshape(N, 2, size, -1))
                # block k's states are dead once its group is done
                states[k] = None
                offset += size
                mark(f"block{k}")
        style_change = np.concatenate(per_block, axis=2)
    else:
        eff = run_sweep(N * 2 * C, _sweep_ids(N, 0, C, device))
        style_change = eff.reshape(N, 2, C, -1)
        mark("sweep")

    host = lambda t: t.float().cpu().numpy()
    originals = images[keep] if shown is None else host(shown[:N])
    if noise is None:
        noise = np.zeros((1, *originals.shape[1:3], 1), np.float32)
    with tracing.span("attfind.records"):
        records = AttFindRecords(
            style_change=style_change.astype(np.float32),
            latents=host(w_all),
            base_prob=host(base_all),
            minima=host(minima),
            maxima=host(maxima),
            style_coordinates=host(coords_all),
            original_images=originals,
            noise=np.asarray(noise, np.float32),
            discriminator=host(d_all)[:, None],
            stage_walls=stage_walls,
        )
    mark("records_fetch")
    return records


@torch.no_grad()
def find_discriminator_threshold(model: StylEx, classifier_fn: Classify, images: np.ndarray,
                                 noise: np.ndarray, phase1_batch: int = 64) -> np.ndarray:
    """D scores of the encoder-reconstructed images, used to pick a realism
    threshold. Runs on the device and in the dtype of ``model``."""
    param = next(model.parameters())
    noise_t = torch.from_numpy(np.asarray(noise, np.float32)).to(param.device, param.dtype)
    images = np.asarray(images, np.float32)
    outs = []
    for start in range(0, images.shape[0], phase1_batch):
        chunk = _to_device(images[start:start + phase1_batch], param.device, param.dtype)
        outs.append(model.sweep_phase1(chunk, classifier_fn, noise_t, False)[2]
                    .float().cpu().numpy())
    return np.concatenate(outs)


# ---------------------------------------------------------------- records IO


def _datasets(records: AttFindRecords) -> Dict[str, np.ndarray]:
    """The reference schema's datasets: float32, minima and maxima (1, C),
    images NCHW."""
    return {
        "style_change": records.style_change.astype("f4"),
        "latents": records.latents.astype("f4"),
        "base_prob": records.base_prob.astype("f4"),
        "minima": records.minima[None].astype("f4"),
        "maxima": records.maxima[None].astype("f4"),
        "style_coordinates": records.style_coordinates.astype("f4"),
        "original_images": records.original_images.transpose(0, 3, 1, 2).astype("f4"),
        "noise": records.noise.astype("f4"),
        "discriminator": records.discriminator.astype("f4"),
    }


def _from_datasets(f) -> AttFindRecords:
    return AttFindRecords(
        style_change=np.array(f["style_change"]),
        latents=np.array(f["latents"]),
        base_prob=np.array(f["base_prob"]),
        minima=np.array(f["minima"])[0],
        maxima=np.array(f["maxima"])[0],
        style_coordinates=np.array(f["style_coordinates"]),
        original_images=np.array(f["original_images"]).transpose(0, 2, 3, 1),
        noise=np.array(f["noise"]),
        discriminator=np.array(f["discriminator"]),
    )


def save_records_hdf5(records: AttFindRecords, path: str) -> str:
    """Write ``style_change_records.hdf5`` with the reference's dataset
    names and shapes. Images are stored NCHW to match."""
    import h5py

    with h5py.File(path, "w") as f:
        for name, data in _datasets(records).items():
            f.create_dataset(name, data=data)
    return path


def load_records_hdf5(path: str) -> AttFindRecords:
    import h5py

    with h5py.File(path, "r") as f:
        return _from_datasets(f)


def save_records(records: AttFindRecords, path: str) -> str:
    """The records to ``path``: a ``.npz`` of the reference schema's
    datasets, or else the reference's hdf5."""
    if str(path).endswith(".npz"):
        np.savez(path, **_datasets(records))
        return path
    return save_records_hdf5(records, path)


def load_records(path: str) -> AttFindRecords:
    """Records from a ``.npz`` of :func:`save_records` or an hdf5 file of
    the reference schema."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            return _from_datasets(f)
    return load_records_hdf5(path)


def records_file_name() -> str:
    """``style_change_records.hdf5``, or ``.npz`` where h5py is not
    installed."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return "style_change_records.npz"
    return "style_change_records.hdf5"
