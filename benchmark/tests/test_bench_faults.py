"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped, each cell driven on the CPU at a tiny
size with a fault planted in the program, and the lower-precision control
put in the program's place failing the comparison."""

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark import run as bench

from conftest import ROOT, tiny_context


def _correct(ctx, rec) -> bool:
    spec = common.load_json(ROOT / "BENCHMARK.json")
    return bench.result_line(spec, ctx, rec, common.card(torch.device("cpu")))["correct"]


def test_a_sweep_answer_altered_where_it_is_made(monkeypatch):
    from stylex_tpu_torch.attfind import extraction

    real = extraction._sweep_chunk

    def next_coordinate(model, classify, w_all, noise, coords_all, minima, maxima, base_all,
                        img_idx, coord_idx, *args):
        coord_idx = (coord_idx + 1) % model.total_style_coords
        return real(model, classify, w_all, noise, coords_all, minima, maxima, base_all,
                    img_idx, coord_idx, *args)

    monkeypatch.setattr(extraction, "_sweep_chunk", next_coordinate)
    ctx, driver = tiny_context("plant64.attfind")
    assert not _correct(ctx, driver.run(ctx))


def _wrap_step(monkeypatch, wrap):
    from stylex_tpu_torch.train import trainer

    real = trainer.make_train_step
    monkeypatch.setattr(trainer, "make_train_step", lambda *a, **k: wrap(real(*a, **k)))


def _unchanged(step, state, batch, draws):
    """The step, with the state's parameters put back after it."""
    saved = [p.detach().clone() for p in state.model.parameters()]
    metrics = step(state, batch, draws)
    with torch.no_grad():
        for p, s in zip(state.model.parameters(), saved):
            p.copy_(s)
    return metrics


def _half(step, state, batch, draws):
    """The step on half of its batch and draws, the mean over the rest."""
    from benchmark.drivers.train import half_batch
    from stylex_tpu_torch.ops.diffaug import AugmentDraws
    from stylex_tpu_torch.train.steps import PhaseDraws, StepDraws

    A = batch["d_real"].shape[0]
    batch = {k: half_batch(v, A).numpy() for k, v in batch.items()}

    def phase(d):
        aug = {k: AugmentDraws(*half_batch(tuple(getattr(d, k)), A))
               for k in ("aug_fake", "aug_real")}
        rest = {k: half_batch(getattr(d, k), A) for k in
                ("z1", "z2", "mixed", "cutoff", "noise", "pl_noise")}
        return PhaseDraws(**rest, **aug)

    return step(state, batch, StepDraws(phase(draws.d), phase(draws.g)))


FAULTS = {"unchanged": _unchanged, "half_batch": _half}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell, window_only", [("plant64.train", False),
                                               ("ffhq256.train", True)])
def test_a_broken_step(monkeypatch, fault, cell, window_only):
    """Every step broken; or set-up's steps sound and the window's broken,
    as a path that starts after the warm-up would break them, which the
    window's own compared steps catch."""
    ctx, driver = tiny_context(cell)
    sound = ctx.workload["params"]["warmup_steps"] if window_only else 0
    calls = [0]

    def wrap(step):
        def broken(*a):
            calls[0] += 1
            return step(*a) if calls[0] <= sound else FAULTS[fault](step, *a)
        return broken

    _wrap_step(monkeypatch, wrap)
    rec = driver.run(ctx)
    if window_only:
        setup = [v <= limit for name, v, limit in rec["checks"] if not name.startswith("window")]
        assert all(setup), rec["checks"]
    assert not _correct(ctx, rec)


# the sweep at 32 px: MobileNetV2 then sees images as large as its stem
# expects, where TF32's rounding shows as it does at the cell's 64 px
SWEEP_32 = dict(image_size=32, network_capacity=4, latent_dim=34, encoder_dim=32, fmap_max=32)


@pytest.mark.parametrize("cell, model", [("plant64.attfind", SWEEP_32), ("plant64.train", None),
                                         ("ffhq256.train", None)])
def test_the_lower_precision_control_fails(cell, model):
    ctx, driver = tiny_context(cell, control=True, model=model)
    rec = driver.run(ctx)
    limits = ctx.workload["params"]["limits"]
    control = rec["control"]
    assert any(control[k] > v for k, v in limits.items()), (control, limits)
    # the planted fault fails too
    fault = next(v for k, v in control.items() if k.startswith("fault_"))
    assert any(fault[k] > v for k, v in limits.items()), (fault, limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["plant64.attfind", "plant64.train", "ffhq256.train"])
def test_at_the_cells_size_sound_runs_pass_and_the_control_fails(card, cell):
    ctx, driver = bench.prepare(cell, 2147483710, 0.0, False, card, control=True)
    rec = driver.run(ctx)
    limits = ctx.workload["params"]["limits"]
    assert all(v <= limit for _, v, limit in rec["checks"]), rec["checks"]
    assert any(rec["control"][k] > v for k, v in limits.items()), (rec["control"], limits)


def test_the_images_must_come_from_the_folder():
    from benchmark.drivers.train import own_batches

    decoded = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    good = {"d_real": decoded[[1, 0]][None]}
    bad = {"d_real": (decoded[[1, 0]] + 1)[None]}
    assert own_batches([good], decoded)[1] == 0
    assert own_batches([bad], decoded)[1] == 2
