"""Helpers of the benchmark's own tests: a cell's run context on the CPU at
a tiny size (the drivers take everything from it), and the ``card``
marker of the tests that need a GPU.

Run with ``python -m pytest benchmark/tests``; the ``card`` tests run on a
machine with a GPU and skip elsewhere.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench  # noqa: E402

TINY_MODEL = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32, fmap_max=64)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


def tiny_context(cell: str, seed: int = 2147483700, trace: bool = False, control: bool = False,
                 model=None):
    """``cell``'s context on the CPU, cut to a size a test can hold: the
    model to ``TINY_MODEL`` (or ``model``), two images a call, two steps of
    2 x 2 images."""
    torch.set_num_threads(4)
    ctx, driver = bench.prepare(cell, seed, 0.0, trace, torch.device("cpu"), control)
    ctx.config["model"].update(model or TINY_MODEL)
    p = ctx.workload["params"]
    if ctx.workload["driver"] == "attfind":
        p.update(images_per_call=2, sets=2, coord_batch=64, compare_per_block=8)
    else:
        p.update(images=16, trace_steps=2)
        ctx.config["train"].update(batch_size=2, gradient_accumulate_every=2)
    return ctx, driver


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
