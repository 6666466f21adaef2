"""One process per rank: :func:`launch` starts the ranks of a data-parallel
group on one host and returns what each returned.

    from stylex_tpu_torch.parallel import launch
    results = launch(fn, 2, "cuda")          # rank r on cuda:r, NCCL
    results = launch(fn, 2, "cpu")           # two host ranks, gloo
    results = launch(fn, 2, ["cuda:0", "cuda:0"])  # two ranks share a card, gloo

``fn(mesh, *args)`` runs in every rank with that rank's
:class:`~stylex_tpu_torch.parallel.mesh.Mesh`; it must be a top-level
function of an importable module (the workers are spawned, not forked). The
ranks meet at a ``file://`` rendezvous in a fresh temporary directory, so no
port is chosen. NCCL joins ranks on distinct cards; gloo joins host ranks and
ranks that share a card (NCCL refuses two ranks on one card), carrying
``all_reduce``, ``broadcast`` and ``barrier`` on CUDA tensors through the
host. A worker's exception ends the others and is raised here.

:func:`resolve_num_devices` is the rank count of the training CLI, by the JAX
trainer's rule.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from stylex_tpu_torch.parallel.mesh import Mesh, _set_current

__all__ = ["launch", "resolve_num_devices"]

Devices = Union[None, str, torch.device, Sequence[Union[str, torch.device]]]


def _gpu_count(device) -> int:
    """GPUs present for ``device`` (None or a CUDA device); raises without
    one, as the single-process entry points do."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is available; pass device='cpu' to run "
                           f"on the host (device {device!r})")
    return torch.cuda.device_count()


def _one_device(device) -> bool:
    """``device`` names a single device: the host, or an indexed card."""
    if device is None or isinstance(device, (list, tuple)):
        return False
    device = torch.device(device)
    return device.type == "cpu" or device.index is not None


def resolve_num_devices(num_devices: Optional[int], batch_size: int, device=None) -> int:
    """The training rank count. ``None``: the JAX trainer's default, the
    largest count up to the GPUs present that divides ``batch_size``, for
    ``device`` None or ``'cuda'``; 1 under ``'cpu'`` or an indexed card
    (``'cuda:1'`` trains on that card alone). An explicit count must divide
    ``batch_size`` and, on the GPU, not exceed the GPUs present; above 1 it
    puts rank r on ``cuda:r``, so an indexed card refuses it."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if num_devices is None:
        if _one_device(device) or not torch.cuda.is_available():
            return 1  # the single-process path raises where no GPU is
        n = torch.cuda.device_count()
        while batch_size % n:
            n -= 1
        return n
    if num_devices < 1:
        raise ValueError(f"num_devices must be at least 1, got {num_devices}")
    if batch_size % num_devices:
        raise ValueError(f"num_devices={num_devices} does not divide batch_size={batch_size}: "
                         "each rank takes an equal slice of every micro-batch")
    if not on_cpu and num_devices > 1:
        _check_unindexed(num_devices, device)
        present = _gpu_count(device)
        if num_devices > present:
            raise ValueError(f"num_devices={num_devices} but {present} GPU(s) are present")
    return num_devices


def _check_unindexed(num_devices: int, device) -> None:
    if _one_device(device) and torch.device(device).type == "cuda":
        raise ValueError(f"num_devices={num_devices} puts rank r on cuda:r, but device "
                         f"{str(device)!r} names one card: pass device 'cuda'")


def _rank_devices(num_devices: int, device: Devices = None) -> List[torch.device]:
    """Each rank's device: ``cuda:r`` for None or ``'cuda'``, the host for
    ``'cpu'``, an indexed card for its one rank, or the given list (ranks
    may repeat a device)."""
    if isinstance(device, (list, tuple)):
        if len(device) != num_devices:
            raise ValueError(f"{len(device)} devices for {num_devices} ranks")
        devices = [torch.device(d) for d in device]
    elif device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")] * num_devices
    elif _one_device(device) and num_devices == 1:
        devices = [torch.device(device)]
    else:
        _check_unindexed(num_devices, device)
        devices = [torch.device("cuda", r) for r in range(num_devices)]
    if any(d.type == "cuda" for d in devices):
        present = _gpu_count(device)
        if any(d.type == "cuda" and (d.index or 0) >= present for d in devices):
            raise ValueError(f"ranks on {[str(d) for d in devices]}, but {present} GPU(s) "
                             f"are present")
    return devices


def _worker(index: int, fn: Callable, args: tuple, devices: List[torch.device], backend: str,
            rendezvous: str, results: str, threads: int) -> None:
    device = devices[index]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    # a host of one machine: the loopback carries gloo's and NCCL's bootstrap
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=index,
                            world_size=len(devices))
    mesh = Mesh(rank=index, world_size=len(devices), device=device,
                group=dist.group.WORLD)
    _set_current(mesh)
    try:
        out = fn(mesh, *args)
        torch.save(out, Path(results) / f"{index}.pt")
        mesh.barrier()
    finally:
        _set_current(None)
        dist.destroy_process_group()


def launch(fn: Callable, num_devices: int, device: Devices = None, args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` in ``num_devices`` spawned ranks and return
    the ranks' results in rank order (each saved with ``torch.save``, so
    tensors come back on their devices' types; move them to the host in
    ``fn`` to read them without a GPU).

    ``device``: None or ``'cuda'`` puts rank r on ``cuda:r`` (raises without
    a GPU or with too few), ``'cpu'`` runs every rank on the host, an
    indexed card (``'cuda:1'``) takes one rank, a list names each rank's
    device. The backend is NCCL where every rank has a
    card of its own, else gloo. A CPU rank takes this process's torch
    threads divided by the rank count. One device still forms a group of
    one, so the distributed code runs on a single card.
    """
    devices = _rank_devices(num_devices, device)
    own_cards = (all(d.type == "cuda" for d in devices)
                 and len({d.index for d in devices}) == len(devices))
    backend = "nccl" if own_cards else "gloo"
    threads = max(1, torch.get_num_threads() // num_devices)
    tmp = tempfile.mkdtemp(prefix="stylex_launch_")
    try:
        mp.start_processes(_worker, nprocs=num_devices, join=True, start_method="spawn",
                           args=(fn, tuple(args), devices, backend,
                                 os.path.join(tmp, "rendezvous"), tmp, threads))
        return [torch.load(Path(tmp) / f"{r}.pt", weights_only=False)
                for r in range(num_devices)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
