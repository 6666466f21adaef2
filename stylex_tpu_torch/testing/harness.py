"""Rank functions that hold a data-parallel group against one process on
explicit inputs.

Spawned ranks import the function they run, so these live in an
importable module; ``tests/test_torch_parallel.py`` launches them on host
ranks (gloo) and ``chip_smoke.py`` on the card. Each takes a rank's
:class:`~stylex_tpu_torch.parallel.mesh.Mesh` (the trivial one for the
single process) and picklable inputs, and returns host values:

* :func:`step_case`: one train step from a given state, global batch and
  global draws, with Adam or a plain gradient step that keeps the
  gradients it applied (the ranks' reduced sum), optionally with the
  step's kinks smoothed (:func:`smooth_kinks`);
* :func:`trainer_case`: ``Trainer.train()`` steps on the synthetic set:
  each step's logged metrics, the state after a chosen step, every rank's
  state (or its digest), ms per step, kernel launches, and the gradient
  all-reduce's bytes and ms per step;
* :func:`sweep_case`: an AttFind extraction, and :func:`attfind_cli_case`:
  ``run_attfind`` on its flags;
* :func:`mesh_case`: the mesh helpers on seeded values.

:func:`run` runs a list of ``(name, inputs)`` cases in one launch.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from stylex_tpu_torch.device import map_tensors, set_float32_precision
from stylex_tpu_torch.parallel.mesh import (
    GRAD_ALL_REDUCE,
    Mesh,
    all_reduce_grads,
    coordinate_sharding,
    data_sharding,
    gather,
    replicated,
    shard_batch,
)

__all__ = ["PlainStep", "smooth_kinks", "step_case", "trainer_case", "sweep_case",
           "attfind_cli_case", "mesh_case", "run", "state_tensors"]


class PlainStep(torch.optim.Optimizer):
    """p <- p - lr * grad, keeping the gradients of its last step on the
    host in parameter order (``grads``). ``lr=-1`` adds the gradient, as
    ``optax.scale(1.0)`` does."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))
        self.grads: List[torch.Tensor] = []

    @torch.no_grad()
    def step(self, closure=None):
        self.grads = []
        for group in self.param_groups:
            for p in group["params"]:
                self.grads.append(p.grad.detach().cpu().clone())
                p.add_(p.grad, alpha=-group["lr"])


@contextlib.contextmanager
def smooth_kinks(eps: float = 1e-2):
    """Inside, the kinked functions of a train step (leaky ReLU in G, D and
    E; ReLU in the hinge loss, ResNet-18 and LPIPS; their max pooling) are
    smooth: ``(1+a)/2 x + (1-a)/2 sqrt(x^2 + eps)`` for slope a, and average
    pooling. At a kink, float32 rounding decides on which side an
    activation falls, and one flipped activation moves its weights'
    gradients by about 1 / (positions in the batch), beyond a per-element
    tolerance: a step summed in another order (another device, another
    split over ranks, weights moved by 1e-6 of themselves) differs so.
    Without kinks the step is smooth, and two such steps must agree
    element by element."""
    import torch.nn.functional as F

    saved = F.leaky_relu, F.relu, F.max_pool2d

    def leaky(x, negative_slope=0.01, inplace=False):
        a = negative_slope
        return (1 + a) / 2 * x + (1 - a) / 2 * torch.sqrt(x * x + eps)

    F.leaky_relu = leaky
    F.relu = lambda x, inplace=False: leaky(x, 0.0)
    F.max_pool2d = lambda x, kernel_size, stride=None, padding=0, *args, **kwargs: F.avg_pool2d(
        x, kernel_size, stride, padding)
    try:
        yield
    finally:
        F.leaky_relu, F.relu, F.max_pool2d = saved


def _host(tree):
    return map_tensors(tree, lambda t: t.detach().cpu())


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a :class:`~stylex_tpu_torch.train.state.TrainState`
    by name: the model's state dict (``model.<key>``: live nets, EMA copies,
    codebooks), both optimizers' moments and counts
    (``<g_opt|d_opt>.<parameter>.<exp_avg|exp_avg_sq|step>``), and
    ``pl_mean``."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    names = {p: k for k, p in state.model.named_parameters()}
    for opt_name in ("g_opt", "d_opt"):
        for p, per_param in getattr(state, opt_name).state.items():
            for k, v in per_param.items():
                if torch.is_tensor(v):
                    out[f"{opt_name}.{names[p]}.{k}"] = v
    out["pl_mean"] = state.pl_mean
    return out


def _digest(tensors: Dict[str, torch.Tensor]) -> Dict[str, str]:
    return {k: hashlib.sha256(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def _classifier(spec: Tuple[str, int, int, Optional[dict]], device):
    from stylex_tpu_torch.models import build_classifier

    kind, size, classes, state_dict = spec
    clf = build_classifier(kind, size, classes, device="cpu")
    if state_dict is not None:
        clf.net.load_state_dict(state_dict)
    clf.net.requires_grad_(False)
    clf.net.to(device)
    return clf


def step_case(mesh: Mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    """One train step. ``case``: ``model_cfg``, ``train_cfg``,
    ``state_dict`` (the model's; None: ``build_stylex`` from ``seed``),
    ``step``, ``pl_mean``, ``classifier``
    ((kind, image size, classes, state dict or None)), ``lpips`` (params),
    ``batch`` (the global (A, B, ...) stacks), ``draws`` (the global
    StepDraws), ``optimizer`` ('adam', or a :class:`PlainStep` learning
    rate), ``env`` (variables set for the step), ``smooth_kinks`` (an eps
    for :func:`smooth_kinks`, or None), ``keep`` (the heavy results to
    return, of ``'state_dict'`` and ``'grads'``; default both),
    ``every_rank`` (False: only rank 0 returns them). Returns the metrics,
    ``step``, ``pl_mean``, the model's state dict after the step and, with
    a plain step, the gradients it applied by parameter name."""
    env = case.get("env", {})
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    eps = case.get("smooth_kinks")
    try:
        with smooth_kinks(eps) if eps is not None else contextlib.nullcontext():
            return _step_case(mesh, case)
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _step_case(mesh: Mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    from stylex_tpu_torch.models.stylex import StylEx, build_stylex
    from stylex_tpu_torch.train import create_train_state, make_train_step

    dev = mesh.device
    cfg, tc = case["model_cfg"], case["train_cfg"]
    if tc.compute_dtype == "float32":
        set_float32_precision()  # as the Trainer does
    if case["state_dict"] is None:
        model = build_stylex(cfg, seed=case.get("seed", 0), device=dev)
    else:
        model = StylEx(cfg)
        model.load_state_dict(case["state_dict"])
        model.to(dev)
    state = create_train_state(model, cfg, tc)
    lr = case.get("optimizer", "adam")
    if lr != "adam":
        state.g_opt = PlainStep([p for g in state.g_opt.param_groups for p in g["params"]], lr)
        state.d_opt = PlainStep(list(model.D.parameters()), lr)
    state.step = int(case["step"])
    state.pl_mean = torch.tensor(float(case["pl_mean"]), device=dev)
    clf = _classifier(case["classifier"], dev)
    lpips = map_tensors(case["lpips"], lambda t: t.to(dev))
    step = make_train_step(cfg, tc, clf.classify_images, lpips, mesh=mesh)
    batch = shard_batch(mesh, case["batch"], batch_axis=1)
    draws = map_tensors(case["draws"], lambda t: t.to(dev))
    metrics = step(state, batch, draws)
    out = dict(metrics={k: float(v) for k, v in metrics.items()}, step=state.step,
               pl_mean=float(state.pl_mean))
    keep = case.get("keep", ("state_dict", "grads"))
    if mesh.rank != 0 and not case.get("every_rank", True):
        keep = ()
    if "state_dict" in keep:
        out["state_dict"] = _host(model.state_dict())
    if lr != "adam" and "grads" in keep:
        names = {p: n for n, p in model.named_parameters()}
        params = [p for opt in (state.g_opt, state.d_opt) for g in opt.param_groups
                  for p in g["params"]]
        out["grads"] = dict(zip((names[p] for p in params), state.g_opt.grads + state.d_opt.grads))
    return out


def _time_grad_all_reduce(mesh: Mesh, model, reps: int = 5) -> Dict[str, float]:
    """ms of one step's gradient all-reduce: the D phase's bucket, then the
    G phase's, on zero gradients of the model's shapes; median of ``reps``."""
    from stylex_tpu_torch.train.state import g_parameters

    buckets = [[torch.zeros_like(p) for p in model.D.parameters()],
               [torch.zeros_like(p) for p in g_parameters(model)]]
    cuda = mesh.device.type == "cuda"
    times = []
    for _ in range(reps + 1):
        mesh.barrier()
        if cuda:
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        for grads in buckets:
            all_reduce_grads(grads, mesh)
        if cuda:
            torch.cuda.synchronize(mesh.device)
        times.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(g.numel() * g.element_size() for grads in buckets for g in grads)
    return dict(bytes=nbytes, ms=float(np.median(times[1:])))


def trainer_case(mesh: Mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    """``case['steps']`` ``Trainer.train()`` calls on the synthetic set.
    ``case``: ``trainer`` (Trainer keyword arguments: configs, classifier,
    seed, directories), ``steps``, ``snapshot_after`` (a step after which
    rank 0 returns Adam's first moments, ``m = (1 - b1) g`` after a first
    step, or None), ``full_state`` (return every state tensor, else their
    digests where there are several ranks to compare). Returns each logged step's metrics, ms per
    ``train()`` call, the kernel launches, the snapshot, the final state or
    its digests, and (in a process group) the gradient all-reduce's bytes
    and ms per step."""
    from stylex_tpu_torch.ops import LAUNCHES, reset_launches
    from stylex_tpu_torch.train.trainer import Trainer

    trainer = Trainer(device=mesh.device, **case["trainer"])
    logged: Dict[int, Dict[str, float]] = {}
    log = trainer.logger.log

    def keep(step, metrics):
        logged[step] = dict(metrics)
        log(step, metrics)

    trainer.logger.log = keep
    snapshot = None
    ms: List[float] = []
    cuda = mesh.device.type == "cuda"
    try:
        trainer.set_data_src("./", "synthetic")
        trainer.init_stylex()
        reset_launches()
        reduced = dict(GRAD_ALL_REDUCE)
        for i in range(case["steps"]):
            if cuda:
                torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            trainer.train()
            if cuda:
                torch.cuda.synchronize(mesh.device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == case.get("snapshot_after") and mesh.rank == 0:
                snapshot = _host({k: v for k, v in state_tensors(trainer.state).items()
                                  if k.endswith(".exp_avg")})
        trainer.flush()
        launches = dict(LAUNCHES)
        grad_bytes = (GRAD_ALL_REDUCE["bytes"] - reduced["bytes"]) / case["steps"]
        tensors = state_tensors(trainer.state)
        final = (_host(tensors) if case.get("full_state")
                 else _digest(tensors) if mesh.world_size > 1 else None)
        out = dict(rank=mesh.rank, metrics=logged, ms=ms, launches=launches,
                   snapshot=snapshot, state=final, step=trainer.state.step)
        if mesh.group is not None:
            out["grad_all_reduce"] = dict(_time_grad_all_reduce(mesh, trainer.state.model),
                                          bytes_per_step=grad_bytes)
        return out
    finally:
        trainer.close()


def sweep_case(mesh: Mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    """An AttFind extraction. ``case``: ``model_cfg``, ``state_dict``,
    ``classifier`` (as in :func:`step_case`), ``images``, ``noise`` and
    :func:`~stylex_tpu_torch.attfind.attfind_extraction` keyword arguments
    (``kwargs``). Returns the records' arrays."""
    from stylex_tpu_torch.attfind import attfind_extraction
    from stylex_tpu_torch.models.stylex import StylEx

    model = StylEx(case["model_cfg"])
    model.load_state_dict(case["state_dict"])
    model.to(mesh.device).eval()
    clf = _classifier(case["classifier"], mesh.device)
    rec = attfind_extraction(model, clf.classify_images, case["images"], case["noise"],
                             progress=False, mesh=mesh, **case.get("kwargs", {}))
    return {k: v for k, v in vars(rec).items() if isinstance(v, np.ndarray)}


def mesh_case(mesh: Mesh, case: Dict[str, Any]) -> Dict[str, Any]:
    """The helpers on a global ``x`` (rows, cols) and ``w`` (cols, k):
    this rank's :func:`data_sharding` slices of ``sizes`` and
    :func:`coordinate_sharding` slices of ``flat_sizes``, :func:`replicated`
    of a rank-dependent tensor, the :func:`gather` of this rank's rows of
    ``x`` (dim 0) and of its columns of ``x.T`` (dim 1), and the gradients
    of a loss that couples the rows (the squares of softmaxes of the
    gathered ``x @ w`` over the rows, summed) at this rank's rows and, after
    :func:`all_reduce_grads`, at ``w``."""
    x = case["x"].to(mesh.device)
    rows = data_sharding(mesh, x.shape[0])
    local = x[rows].clone().requires_grad_(True)
    w = case["w"].to(mesh.device).clone().requires_grad_(True)

    # the step's pattern: per-sample values from this rank's rows, gathered,
    # then a loss that couples them
    loss = (torch.softmax(gather(local @ w, mesh, dim=0), dim=0) ** 2).sum()
    grad_x, grad_w = torch.autograd.grad(loss, [local, w])
    grad_w = all_reduce_grads([grad_w], mesh)[0]
    full = gather(local, mesh, dim=0)
    cols = gather(x.t()[:, rows].contiguous(), mesh, dim=1)
    mine = torch.full((3,), float(mesh.rank + 1), device=mesh.device)
    replicated(mesh, mine)
    return dict(rank=mesh.rank, gathered=_host(full.detach()), gathered_t=_host(cols),
                grad_x=_host(grad_x), grad_w=_host(grad_w), replicated=_host(mine),
                data_slices=[data_sharding(mesh, n) for n in case["sizes"]],
                coord_slices=[coordinate_sharding(mesh, n) for n in case["flat_sizes"]])


def attfind_cli_case(mesh: Mesh, argv: List[str]) -> Dict[str, Any]:
    """``run_attfind`` with the flags ``argv`` on this rank: its summary,
    with the kernel launches counted from 0."""
    from stylex_tpu_torch import run_attfind
    from stylex_tpu_torch.ops import reset_launches

    reset_launches()
    return run_attfind.extract(mesh, run_attfind.parse_args(argv))


CASES = {"step": step_case, "trainer": trainer_case, "sweep": sweep_case, "mesh": mesh_case,
         "run_attfind": attfind_cli_case}


def run(mesh: Mesh, cases: List[Tuple[str, Dict[str, Any]]]) -> list:
    """Each ``(name, inputs)`` case in order (``name`` a key of
    :data:`CASES`); their results."""
    return [CASES[name](mesh, inputs) for name, inputs in cases]
