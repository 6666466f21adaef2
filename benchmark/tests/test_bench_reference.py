"""The frozen reference against the program under test, on the CPU at
small sizes, with the same weights made by the benchmark."""

import torch

from benchmark import common
from benchmark.reference import nets

from conftest import TINY_MODEL, tiny_context


def _weights(c, kind, lpips=False):
    return common.make_weights(common.reference_shapes(c, kind, lpips), 2147483701, "cpu")


def test_generator_d_e_and_classifiers_match_the_program():
    ctx, driver = tiny_context("plant64.attfind")
    c = ctx.config["model"]
    for kind in ("mobilenet", "resnet"):
        w = _weights(c, kind)
        prog, clf = driver._program(c, kind, w, torch.device("cpu"))
        ref, rclf = driver._reference(c, kind, w, torch.device("cpu"))
        g = torch.Generator().manual_seed(3)
        styles = torch.randn(3, ref.num_layers, c["latent_dim"], generator=g)
        noise = torch.rand(1, c["image_size"], c["image_size"], 1, generator=g)
        delta = torch.zeros(3, sum(a + b for a, b in nets.block_dims(16, 4, 64)))
        delta[0, 5], delta[1, 40], delta[2, -1] = 0.7, -1.3, 2.0
        with torch.no_grad():
            a_img, a_coords = prog.generate(styles, noise, style_delta=delta)
            b_img, b_coords = ref.G(styles, noise, style_delta=delta)
            assert common.relative_gap(a_img, b_img) < 1e-5
            assert common.relative_gap(a_coords, b_coords) < 1e-6
            x = torch.rand(4, 3, 16, 16, generator=g)
            assert common.relative_gap(prog.encode(x), ref.encoder(x)) < 1e-5
            assert common.relative_gap(prog.discriminate(x), ref.D(x)) < 1e-5
            assert common.relative_gap(clf.classify_images(x), rclf(x)) < 1e-5


def test_new_arch_d_matches_the_program():
    ctx, driver = tiny_context("plant64.attfind", model={**TINY_MODEL, "arch": "new"})
    c = ctx.config["model"]
    w = _weights(c, "mobilenet")
    prog, _ = driver._program(c, "mobilenet", w, torch.device("cpu"))
    ref, _ = driver._reference(c, "mobilenet", w, torch.device("cpu"))
    x = torch.rand(4, 3, 16, 16)
    p = torch.softmax(torch.randn(4, 2), -1)
    with torch.no_grad():
        assert common.relative_gap(prog.discriminate(x, p), ref.D(x, p)) < 1e-5


def test_the_sweep_cell_runs_correct_on_the_cpu():
    ctx, driver = tiny_context("plant64.attfind")
    rec = driver.run(ctx)
    assert rec["failed"] == 0
    for name, value, limit in rec["checks"]:
        assert value <= limit, (name, value, limit)
    assert rec["styles"] == 2 * 2 * sum(a + b for a, b in nets.block_dims(16, 4, 64))


def test_the_train_cells_run_correct_on_the_cpu():
    for cell in ("plant64.train", "ffhq256.train"):
        ctx, driver = tiny_context(cell)
        rec = driver.run(ctx)
        assert rec["steps"] >= 1 and rec["failed"] == 0
        for name, value, limit in rec["checks"]:
            assert value <= limit, (cell, name, value, limit)
