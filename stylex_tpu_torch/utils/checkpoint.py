"""Checkpoint and resume of the whole train state, in the port's format or
the JAX package's.

``<models_dir>/<name>/model_<num>.pt`` beside the model's ``.config.json``,
as the reference lays them out. The file is a ``torch.save`` dict:
``'StylEx'`` holds the model's state dict under the reference's keys (live
nets and EMA copies), so the reference's loaders and the port's
:func:`~stylex_tpu_torch.models.convert.load_reference_checkpoint` read it;
``'g_opt'`` and ``'d_opt'`` the Adam states, ``'step'`` and ``'pl_mean'``
the counters.

``model_<num>.ckpt`` is the JAX package's checkpoint: flax's msgpack of
``{"state": <StylExTrainState as a state dict>, ...}``, read and written by
:mod:`~stylex_tpu_torch.utils.flax_msgpack` and mapped by
:func:`~stylex_tpu_torch.models.convert.load_train_state_from_jax` and
:func:`~stylex_tpu_torch.models.convert.train_state_to_jax`. Either suffix
loads (:func:`load_any_checkpoint`, :func:`load_checkpoint_inference`).

A file is written under a temporary name and renamed, so a reader never
sees half of one. Tensors are written from the host, so a file does not
depend on the device it was saved from. :class:`AsyncCheckpointWriter`
writes the same file from a background thread, off a snapshot of the state
taken on the device.
"""

from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from stylex_tpu_torch.device import map_tensors, to_host_async
from stylex_tpu_torch.utils import flax_msgpack

__all__ = [
    "AsyncCheckpointWriter",
    "save_checkpoint",
    "load_checkpoint",
    "save_jax_checkpoint",
    "load_jax_checkpoint",
    "load_any_checkpoint",
    "load_checkpoint_inference",
    "latest_checkpoint",
    "find_checkpoint",
    "checkpoint_path",
    "read_model_weights",
]

_CKPT_RE = re.compile(r"model_(\d+)\.(pt|ckpt)$")
# on a tie of numbers the port's own file wins
_SUFFIX_RANK = {"pt": 1, "ckpt": 0}


def checkpoint_path(models_dir: str, name: str, num: int, suffix: str = ".pt") -> Path:
    return Path(models_dir) / name / f"model_{num}{suffix}"


def _payload(state, extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """What a checkpoint holds, as references to the live tensors: the
    model's state dict, both Adam states, the step, ``pl_mean`` (a 0-d
    tensor here, a float in the file) and ``extra``."""
    return {
        "StylEx": state.model.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "step": int(state.step),
        "pl_mean": state.pl_mean.detach(),
        **(extra or {}),
    }


def _write_checkpoint_file(path: Path, payload: Dict[str, Any]) -> None:
    """Serialise a payload of host tensors and publish it atomically."""
    payload = {**payload, "pl_mean": float(payload["pl_mean"])}
    tmp = path.with_suffix(".pt.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(models_dir: str, name: str, num: int, state,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` (a :class:`~stylex_tpu_torch.train.state.TrainState`)
    as checkpoint ``num``, blocking; returns its path."""
    path = checkpoint_path(models_dir, name, num)
    path.parent.mkdir(parents=True, exist_ok=True)
    _write_checkpoint_file(path, map_tensors(_payload(state, extra),
                                              lambda t: t.detach().cpu()))
    return str(path)


def _snapshot(tree):
    """A copy of every tensor of ``tree`` that later in-place updates of the
    originals do not reach, bound for the host: ``(host tree, event)``.

    The tensors are cloned on the device, on the current stream, so the next
    train step may update the originals at once. A side stream waits for
    the clones and copies them into pinned host memory without blocking;
    ``event`` (None when no tensor is on a GPU) marks the copies' end, and a
    reader of the host tree on another thread waits for it first: before
    then the host buffers are still being written. The clones are recorded
    on the side stream, so the allocator does not hand their memory to
    other work before the copies have read it."""
    clones = map_tensors(tree, lambda t: t.detach().clone())
    cuda = []
    map_tensors(clones, lambda t: cuda.append(t) if t.is_cuda else None)
    if not cuda:
        return clones, None
    device = cuda[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))

    def to_host(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            t.record_stream(side)
        return to_host_async(t)

    with torch.cuda.stream(side):
        host = map_tensors(clones, to_host)
        done = torch.cuda.Event()
        done.record(side)
    return host, done


class AsyncCheckpointWriter:
    """Writes checkpoints in a background thread, one at a time.

    :meth:`submit` snapshots the state on the device and starts its copies
    to the host (:func:`_snapshot`), then a non-daemon thread waits for
    them, serialises and publishes the file by atomic rename: the file
    :func:`save_checkpoint` would have written, and never a partial one
    under its name. The train loop keeps stepping meanwhile. :meth:`wait`
    (called by the next submit, by every load, and at flush and close)
    joins the thread and raises its error, if any, on the caller's thread.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def wait(self) -> None:
        """Join the write in flight, if any; raise its failure once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, models_dir: str, name: str, num: int, state,
               extra: Optional[Dict[str, Any]] = None) -> str:
        """Start writing ``state`` as checkpoint ``num``; returns its path."""
        self.wait()
        path = checkpoint_path(models_dir, name, num)
        path.parent.mkdir(parents=True, exist_ok=True)
        host, done = _snapshot(_payload(state, extra))

        def write():
            try:
                if done is not None:
                    done.synchronize()
                _write_checkpoint_file(path, host)
            except BaseException as e:  # raised on the caller's thread by wait()
                self._exc = e

        self._thread = threading.Thread(target=write, name=f"ckpt-write-{name}-{num}",
                                        daemon=False)
        self._thread.start()
        return str(path)


def load_checkpoint(path: str, state) -> None:
    """Restore the port's checkpoint ``path`` into ``state`` in place (on the
    state's device)."""
    payload = torch.load(path, map_location=state.device, weights_only=True)
    state.model.load_state_dict(payload["StylEx"])
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
    state.step = int(payload["step"])
    state.pl_mean = torch.tensor(float(payload["pl_mean"]), device=state.device)


def save_jax_checkpoint(models_dir: str, name: str, num: int, state,
                        extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` as the JAX package's ``model_<num>.ckpt``, which its
    ``load_checkpoint`` restores into a ``StylExTrainState`` of the same
    config; returns its path."""
    from stylex_tpu_torch.models.convert import train_state_to_jax

    path = checkpoint_path(models_dir, name, num, ".ckpt")
    flax_msgpack.dump({"state": train_state_to_jax(state), **(extra or {})}, path)
    return str(path)


def load_jax_checkpoint(path: str, state) -> None:
    """Restore the JAX package's checkpoint ``path`` into ``state`` in place:
    live and EMA parameters, the quantize layers' buffers, both Adam states
    (per label in the NEW arch), ``step`` and ``pl_mean``. The file is read
    once; each leaf is copied once, into place."""
    from stylex_tpu_torch.models.convert import load_train_state_from_jax

    load_train_state_from_jax(flax_msgpack.load(path)["state"], state)


def load_any_checkpoint(path: str, state) -> None:
    """:func:`load_jax_checkpoint` for a ``.ckpt``, else
    :func:`load_checkpoint`."""
    (load_jax_checkpoint if str(path).endswith(".ckpt") else load_checkpoint)(path, state)


def _jax_model_weights(state_tree, cfg) -> Dict[str, torch.Tensor]:
    from stylex_tpu_torch.models.convert import stylex_state_dict_from_jax

    return stylex_state_dict_from_jax({**state_tree["params"], **state_tree["ema_params"]}, cfg)


def read_model_weights(path: str, cfg) -> Dict[str, torch.Tensor]:
    """The StylEx state dict (on the host) of a JAX ``.ckpt`` or of a
    reference-layout or port ``.pt``."""
    if str(path).endswith(".ckpt"):
        return _jax_model_weights(flax_msgpack.load(path)["state"], cfg)
    from stylex_tpu_torch.models.convert import load_reference_checkpoint

    return load_reference_checkpoint(path)


def _inference_payload(path: str, cfg) -> Tuple[Dict[str, torch.Tensor], int, float]:
    """(the model's state dict on the host, step, pl_mean) of a checkpoint of
    either suffix; optimizer states are not read into tensors."""
    if str(path).endswith(".ckpt"):
        st = flax_msgpack.load(path)["state"]
        return _jax_model_weights(st, cfg), int(st["step"]), float(st["pl_mean"])
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["StylEx"], int(payload["step"]), float(payload["pl_mean"])


@torch.no_grad()
def load_checkpoint_inference(path: str, state, ship_ema: bool = True,
                              param_dtype: Optional[torch.dtype] = None, device=None) -> None:
    """Like :func:`load_any_checkpoint`, for a model that only infers: the
    parameters and buffers are loaded into ``state.model`` where it lies (the
    host, for the least device memory), cast there to ``param_dtype`` where
    they are float32, and only then placed on ``device``; with
    ``ship_ema=False`` the EMA copies stay on the host in float32. The
    optimizers keep no state, and none is built on the device. AttFind
    sweeps the live nets only, so it loads with ``ship_ema=False``.
    ``device``: the GPU unless ``'cpu'``."""
    from stylex_tpu_torch.device import resolve_device

    device = resolve_device(device)
    sd, step, pl_mean = _inference_payload(path, state.model.cfg)
    state.model.load_state_dict(sd)
    del sd
    state.g_opt.state.clear()
    state.d_opt.state.clear()
    dtype = param_dtype or torch.float32
    for name, module in state.model.named_children():
        if name in ("SE", "GE") and not ship_ema:
            continue
        module.to(dtype).to(device)
    state.step = step
    state.pl_mean = torch.tensor(pl_mean, device=device)


def find_checkpoint(models_dir: str, name: str, num: int) -> Path:
    """Checkpoint ``num`` of either suffix; the port's ``.pt`` where both
    exist. Raises ``FileNotFoundError`` where neither does."""
    for suffix in (".pt", ".ckpt"):
        path = checkpoint_path(models_dir, name, num, suffix)
        if path.exists():
            return path
    raise FileNotFoundError(f"no model_{num}.pt or model_{num}.ckpt under "
                            f"{Path(models_dir) / name}")


def latest_checkpoint(models_dir: str, name: str) -> Optional[Tuple[int, str]]:
    """The highest-numbered checkpoint as (num, path), or None. Both the
    port's ``model_<n>.pt`` and the JAX package's ``model_<n>.ckpt`` count;
    where both have the highest number, the ``.pt`` wins."""
    d = Path(models_dir) / name
    if not d.exists():
        return None
    found = [(int(m.group(1)), _SUFFIX_RANK[m.group(2)], str(f))
             for f in d.iterdir() if (m := _CKPT_RE.search(f.name))]
    if not found:
        return None
    num, _, path = max(found)
    return num, path
