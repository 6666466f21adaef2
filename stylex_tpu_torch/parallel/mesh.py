"""Data parallelism over ``torch.distributed`` ranks: the port's counterpart
of the JAX package's device mesh.

JAX shards one program over a 1-D ``'data'`` mesh: parameters replicated,
batches split along B, XLA inserting the collectives. Here each device is a
process (a rank, started by :func:`stylex_tpu_torch.parallel.launch`) and a
:class:`Mesh` is one rank's view of the group. The semantics are JAX's: an
N-rank train step or AttFind sweep computes what one process computes on the
same global batch and draws.

* Every rank holds the whole model (:func:`replicated` broadcasts rank 0's
  copy) and its contiguous slice of B (:func:`data_sharding`,
  :func:`shard_batch`) or of AttFind's flat perturbation axis
  (:func:`coordinate_sharding`).
* The train step's losses couple the samples of a micro-batch (relativistic
  means, top-k, NT-Xent, the path-length mean), so the step gathers the
  per-sample values (:func:`gather`) and every rank computes the same global
  loss from them. The gather's backward keeps this rank's slot, so each
  rank's parameter gradients hold its own samples' share, and one sum over
  the ranks (:func:`all_reduce_grads`) gives the global gradient. Every rank
  receives the same reduced bits, so the optimizers stay equal.
* The collectives are ``all_reduce``, ``broadcast`` and ``barrier`` only:
  gloo carries them on CUDA tensors too, so two ranks may share one card.

A mesh with no process group (``world_size`` 1 outside a launched worker)
is the single process: every helper is then the identity, and the code paths
run as they do without a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, List, Optional

import torch
import torch.distributed as dist

from stylex_tpu_torch.device import map_tensors, resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "data_sharding",
    "shard_batch",
    "coordinate_sharding",
    "replicated",
    "gather",
    "all_reduce_",
    "all_reduce_grads",
    "GRAD_ALL_REDUCE",
]

# bytes and calls of all_reduce_grads since the process started
GRAD_ALL_REDUCE = {"calls": 0, "bytes": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D data-parallel group."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None  # the process group; None: a single process

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


_CURRENT: Optional[Mesh] = None  # set in a launched worker


def _set_current(mesh: Optional[Mesh]) -> None:
    global _CURRENT
    _CURRENT = mesh


def make_mesh(num_devices: Optional[int] = None, device=None) -> Mesh:
    """The data-parallel mesh of this process.

    Inside a worker started by :func:`~stylex_tpu_torch.parallel.launch`, it
    is that worker's rank in its group (``num_devices``, when given, must be
    the group's size). Outside one, ``num_devices`` of None or 1 gives the
    trivial mesh on ``device`` (default: the GPU), with no process group;
    more devices need one process each, which only ``launch`` starts.
    """
    if _CURRENT is not None:
        if num_devices is not None and num_devices != _CURRENT.world_size:
            raise ValueError(f"num_devices={num_devices} in a group of "
                             f"{_CURRENT.world_size} ranks")
        return _CURRENT
    if num_devices not in (None, 1):
        raise RuntimeError(
            f"num_devices={num_devices} needs one process per device: start the ranks with "
            f"stylex_tpu_torch.parallel.launch (the CLI's --num-devices does)")
    return Mesh(device=resolve_device(device))


def data_sharding(mesh: Mesh, size: int) -> slice:
    """This rank's contiguous slice of a batch axis of ``size``, which the
    world size must divide."""
    if size % mesh.world_size:
        raise ValueError(f"a batch of {size} does not split over {mesh.world_size} ranks")
    per = size // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, tree, batch_axis: int = 1):
    """Every array or tensor of ``tree`` (dicts, lists, tuples) cut to this
    rank's slice along ``batch_axis``: (A, B, ...) micro-batch stacks take
    ``batch_axis=1``, a block of K steps (K, A, B, ...) ``batch_axis=2``.
    Other leaves stay."""
    if mesh.world_size == 1:
        return tree

    def cut(x):
        if not hasattr(x, "shape") or len(x.shape) <= batch_axis:
            return x
        index = [slice(None)] * batch_axis + [data_sharding(mesh, x.shape[batch_axis])]
        return x[tuple(index)]

    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, batch_axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, batch_axis) for v in tree)
    return cut(tree)


def coordinate_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's slice of a flat axis of ``n`` elements, padded to
    ``world_size * ceil(n / world_size)``: every rank takes the same count,
    and the slices past ``n`` are padding the caller fills."""
    per = math.ceil(n / mesh.world_size)
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _on_device(t: torch.Tensor, mesh: Mesh, fn) -> None:
    """``fn`` on ``t`` in place, through a copy on the mesh's device where
    ``t`` lies elsewhere (NCCL takes device tensors only)."""
    if t.device == mesh.device:
        fn(t)
        return
    buf = t.to(mesh.device)
    fn(buf)
    t.copy_(buf)


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.nn.Module):
        return [t for t in (*obj.parameters(), *obj.buffers())]
    out: List[torch.Tensor] = []
    map_tensors(obj, out.append)
    return out


@torch.no_grad()
def replicated(mesh: Mesh, obj):
    """Broadcast rank 0's values of ``obj`` into every rank's, in place: a
    module's parameters and buffers, a tensor, or the tensors of dicts,
    lists and tuples (other leaves are left). Returns ``obj``."""
    if mesh.group is None:
        return obj
    for t in _tensors(obj):
        _on_device(t.data if isinstance(t, torch.nn.Parameter) else t, mesh,
                   lambda b: dist.broadcast(b, src=0, group=mesh.group))
    return obj


def all_reduce_(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place. Returns ``t``."""
    if mesh is not None and mesh.group is not None:
        _on_device(t, mesh, lambda b: dist.all_reduce(b, group=mesh.group))
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= mesh.world_size
        # each element has one non-zero term: the sum is exact in any order;
        # half types travel as float32, which holds them exactly
        wide = torch.promote_types(x.dtype, torch.float32)
        out = torch.zeros(shape, dtype=wide, device=x.device)
        out.narrow(dim, mesh.rank * ctx.size, ctx.size).copy_(x)
        dist.all_reduce(out, group=mesh.group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        # every rank differentiates the same global loss: its slot of the
        # incoming gradient is already the whole gradient of its samples
        return grad.narrow(ctx.dim, ctx.mesh.rank * ctx.size, ctx.size), None, None


def gather(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    global batch of per-sample values), on every rank. Differentiable: the
    backward returns this rank's slot, which is right only when every rank
    computes the same loss from the gathered values. The identity without a
    process group."""
    if mesh is None or mesh.group is None:
        return x
    return _Gather.apply(x, mesh, dim)


@torch.no_grad()
def all_reduce_grads(grads: Iterable[Optional[torch.Tensor]],
                     mesh: Optional[Mesh]) -> List[Optional[torch.Tensor]]:
    """The gradients summed over the ranks: one flat bucket per dtype, one
    ``all_reduce`` each. None entries (a parameter no loss reached, the same
    on every rank) stay None."""
    grads = list(grads)
    if mesh is None or mesh.group is None:
        return grads
    out: List[Optional[torch.Tensor]] = list(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        GRAD_ALL_REDUCE["calls"] += 1
        GRAD_ALL_REDUCE["bytes"] += flat.numel() * flat.element_size()
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out
