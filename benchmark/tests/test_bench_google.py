"""The counters and the ``latent_attfind`` driver of Google's generator on
the CPU: the counted work at the published widths, the driver's gaps 0 on
the reference's own records, and a run at a small size that is correct,
and not correct with a fault planted in the program."""

import numpy as np
import torch

from benchmark import common
from benchmark import run as bench
from benchmark.counters import google as counters
from benchmark.reference import google as ref

from conftest import ROOT

G256 = common.load_json(ROOT / "benchmark" / "configs" / "google256.json")["model"]
SMALL = dict(image_size=32, fmap_base=512, fmap_max=64)


def test_a_256_px_forward_counts_its_convs_affines_and_to_rgbs():
    convs = sum(2 * r * r * i * o * 9 for r, i, o in ref.conv_specs(G256))
    assert round(convs / 1e9, 2) == 56.25
    ch = ref.channels(G256)
    assert ch == {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64}
    to_rgb = sum(2 * r * r * c * 3 for r, c in ch.items())
    widths = sum(i for _, i, _ in ref.conv_specs(G256)) + sum(ch.values())
    affines = 2 * G256["dlatent_dim"] * widths
    assert counters.forward_flops(G256) == convs + to_rgb + affines


def test_the_coordinates_and_the_chunks_of_a_one_dlatent_call():
    assert ref.block_sizes(G256) == [512, 1024, 1024, 1024, 768, 384, 192]
    assert sum(ref.block_sizes(G256)) == 4928
    # 2 x size per resolution in chunks of 512: 2 + 4 + 4 + 4 + 3 + 2 + 1
    assert counters.chunks_per_call(G256, 1, 512) == 20
    small = {**G256, **SMALL}
    work = counters.attfind_call(small, "mobilenet", 2)
    assert work["perturbations"] == 2 * 2 * sum(ref.block_sizes(small))
    assert work["bytes"]["blur"] == 0 and work["bytes"]["upsample"] > 0


def _context(seed=2147483700, control=False):
    torch.set_num_threads(4)
    ctx, driver = bench.prepare("google256.latent_attfind", seed, 0.0, False,
                                torch.device("cpu"), control)
    ctx.config["model"].update(SMALL)
    ctx.workload["params"].update(pool=6, sets=2, coord_batch=96, compare_per_block=8)
    return ctx, driver


class _Records:
    """Records made of the reference's own phase 1 and effects."""

    def __init__(self, r, C):
        n, k = r["base"].shape
        self.style_coordinates = r["coords"].numpy()
        self.base_prob = r["base"].numpy()
        self.original_images = r["images"].permute(0, 2, 3, 1).numpy()
        self.style_change = np.zeros((n, 2, C, k), np.float32)
        ids = r["ids"]
        self.style_change[ids[:, 0], ids[:, 1], ids[:, 2]] = r["effects"].numpy()


def test_the_gaps_are_0_on_the_references_own_records():
    ctx, driver = _context()
    c, p = ctx.config["model"], ctx.workload["params"]
    weights = driver.make_weights(c, "mobilenet", ctx.seed, torch.device("cpu"))
    pool = driver.make_dlatents(c, p["pool"], ctx.seed, torch.device("cpu"))
    calls = [pool[:1].numpy(), pool[1:2].numpy()]
    out = driver.reference_outputs(c, "mobilenet", weights, torch.device("cpu"), calls, pool, p,
                                   ctx.seed)
    C = sum(ref.block_sizes(c))
    result = driver.gaps(driver.program_outputs([_Records(r, C) for r in out], out), out)
    assert result["phase1_gap"] == 0.0 and result["effect_gap"] == 0.0


def _line(ctx, rec):
    spec = common.load_json(ROOT / "BENCHMARK.json")
    return bench.result_line(spec, ctx, rec, common.card(torch.device("cpu")))


def test_a_small_run_is_correct_and_a_next_coordinate_fault_is_not(monkeypatch):
    ctx, driver = _context(control=True)
    rec = driver.run(ctx)
    assert _line(ctx, rec)["correct"]
    assert rec["control"]["fault_next_coordinate"]["effect_gap"] > ctx.workload["params"][
        "limits"]["effect_gap"]

    from stylex_tpu_torch.attfind import extraction

    real = extraction._sweep_chunk

    def next_coordinate(model, classify, w_all, noise, coords_all, minima, maxima, base_all,
                        img_idx, coord_idx, *args):
        coord_idx = (coord_idx + 1) % model.total_style_coords
        return real(model, classify, w_all, noise, coords_all, minima, maxima, base_all,
                    img_idx, coord_idx, *args)

    monkeypatch.setattr(extraction, "_sweep_chunk", next_coordinate)
    ctx, driver = _context()
    line = _line(ctx, driver.run(ctx))
    assert not line["correct"]
    assert line["checks"]["effect_gap"]["value"] > line["checks"]["effect_gap"]["limit"]
