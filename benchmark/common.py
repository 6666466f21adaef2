"""What every driver of the benchmark shares: where things live, the card's
description, weights and images made from the seed on the device, the
process's set-up clock, and the check that no JAX module was loaded.

Nothing here imports the program under test.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]  # the checkout
HERE = Path(__file__).resolve().parent
WORK = ROOT / "build" / "benchmark"  # run-time files: data, trainer outputs, caches

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stylex_tpu")

# the configuration files' model keys that are ModelConfig fields as they stand
MODEL_KEYS = ("image_size", "network_capacity", "fmap_max", "latent_dim", "style_depth",
              "lr_mlp", "num_classes", "encoder_dim")

# published dense peaks of one H100 SXM (NVIDIA's data sheet)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(WORK / "cache" / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A driver's or metric reader's file as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_part_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def since_process_start() -> float:
    """Seconds since this process started (the kernel's clock)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def card(device) -> Dict[str, object]:
    """The card's name, the cards in the run, and the power limit."""
    import torch

    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "power_limit": limit}


# ------------------------------------------------------------------ weights


def _std(name: str, shape) -> float:
    """The spread of a weight drawn for the benchmark, by its name: the
    StylEx init's (kaiming fan-in normal weights, unit-normal mapping
    weights and learned constant), with non-zero biases, noise strengths
    and batch-norm statistics, as a trained model has them."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("initial_block") or (name.startswith("stylex.S.net.") and leaf == "weight"):
        return 1.0
    if "to_noise" in name:
        return 0.1
    if len(shape) >= 2:
        fan_in = 1
        for d in shape[1:]:
            fan_in *= d
        return (2.0 / fan_in) ** 0.5
    return 0.02 if leaf == "bias" else 0.1


def make_weights(shapes: Dict[str, tuple], seed: int, device, dtype=None) -> Dict[str, object]:
    """Weights for every name of ``shapes`` from one normal draw on the
    device (a ``torch.Generator`` seeded with ``seed``), scaled per name.
    Batch-norm scales and variances are 1 plus the draw's magnitude, LPIPS
    taps 1/C, EMA copies (``SE``, ``GE``) equal to their live nets, the
    batch-norm step counters 0."""
    import torch

    dtype = dtype or torch.float32
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    ema = ("stylex.SE.", "stylex.GE.")
    names = [n for n in shapes if not n.startswith(ema) and not n.endswith("num_batches_tracked")]
    total = sum(int(torch.Size(shapes[n]).numel()) for n in names)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for n in names:
        shape = torch.Size(shapes[n])
        x = flat[offset:offset + shape.numel()].view(shape)
        offset += shape.numel()
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "running_var" or (leaf == "weight" and len(shape) == 1):
            x = 1.0 + 0.1 * x.abs()  # batch-norm scale and variance
        elif n.startswith("lpips.lin"):
            x = torch.full_like(x, 1.0 / shape[0])  # LPIPS taps
        else:
            x = x * _std(n, shape)
        out[n] = x.to(dtype)
    for n in shapes:
        if n.startswith(ema):
            out[n] = out[n.replace(".SE.", ".S.", 1).replace(".GE.", ".G.", 1)].clone()
        elif n.endswith("num_batches_tracked"):
            out[n] = torch.zeros((), dtype=torch.long, device=device)
    return out


def split(weights: Dict[str, object], prefix: str) -> Dict[str, object]:
    """The entries under ``prefix.`` with the prefix dropped."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in weights.items() if k.startswith(p)}


def reference_shapes(model_cfg: dict, classifier_kind: str, with_lpips: bool) -> Dict[str, tuple]:
    """name -> shape of every weight the cell needs: ``stylex.*`` (the
    checkpoint's keys), ``classifier.*`` (torchvision's) and ``lpips.*``."""
    import torch

    from benchmark.reference import nets

    with torch.device("meta"):
        model = nets.StylEx(model_cfg)
        clf = nets.Classifier(classifier_kind, model_cfg["image_size"], model_cfg["num_classes"])
    shapes = {f"stylex.{k}": tuple(v.shape) for k, v in model.state_dict().items()}
    shapes.update({f"classifier.{k}": tuple(v.shape) for k, v in clf.net.state_dict().items()})
    if with_lpips:
        shapes.update({f"lpips.{k}": v for k, v in nets.lpips_shapes().items()})
    return shapes


def smooth_images(gen, n: int, size: int, device, grid: int = 8):
    """(n, 3, size, size) float32 images in [0, 1]: a random colour field on
    a ``grid`` x ``grid`` lattice, bilinearly upsampled, with fine noise."""
    import torch
    import torch.nn.functional as F

    coarse = torch.randn(n, 3, grid, grid, generator=gen, device=device)
    x = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    x = x + 0.15 * torch.randn(n, 3, size, size, generator=gen, device=device)
    return torch.sigmoid(1.5 * x)


def free_device_memory() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def relative_gap(a, b) -> float:
    """max |a - b| / max |b| over two tensors of one shape."""
    import torch

    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / max(scale, 1e-30)


def workload_path(name: str) -> Path:
    return HERE / "workloads" / f"{name}.json"
