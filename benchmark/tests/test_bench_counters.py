"""The frozen counters against hand counts at small shapes."""

import json

import torch

from benchmark.counters import work
from benchmark.reference import ops

from conftest import ROOT


def test_one_modulated_conv():
    b, i, o, k, h = 2, 3, 5, 3, 4
    x, w, s = torch.empty(b, i, h, h, device="meta"), torch.empty(o, i, k, k, device="meta"), \
        torch.empty(b, i, device="meta")
    conv = 2 * b * o * i * k * k * h * h  # a multiply-add per tap and output element
    demod = 2 * b * i * o  # (style + 1)^2 @ sum of W^2
    assert work.count_flops(lambda: ops.modulated_conv2d(x, w, s)) == conv + demod
    assert work.count_flops(lambda: ops.modulated_conv2d(x, w, s, demod=False)) == conv


def test_one_upsample_call():
    x = torch.empty(2, 3, 8, 8, device="meta")
    with work.resample_calls() as calls:
        ops.upsample2x(x)
        ops.blur3(torch.empty(2, 3, 16, 16, device="meta"))
    assert calls["upsample"] == [(2 * 3 * 64, 2 * 3 * 256)]
    assert calls["blur"] == [(2 * 3 * 256, 2 * 3 * 256)]


def test_the_block_split_of_a_resume_sweep():
    plant = json.loads((ROOT / "benchmark/configs/plant64.json").read_text())
    ffhq = json.loads((ROOT / "benchmark/configs/ffhq256.json").read_text())
    assert work.block_sizes(plant["model"]) == [1024, 768, 384, 192, 96]
    assert sum(work.block_sizes(plant["model"])) == plant["style_coordinates"] == 2464
    assert sum(work.block_sizes(ffhq["model"])) == ffhq["style_coordinates"] == 4512
    # 32 images, chunks of 512: each block's 64 * size perturbations
    assert work.chunks_per_call(plant["model"], 32, 512) == 128 + 96 + 48 + 24 + 12


def test_a_call_counts_each_perturbation_once():
    c = dict(json.loads((ROOT / "benchmark/configs/plant64.json").read_text())["model"])
    c.update(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32, fmap_max=64)
    one, two = work.attfind_call(c, "mobilenet", 1), work.attfind_call(c, "mobilenet", 2)
    assert two["perturbations"] == 2 * one["perturbations"] == 2 * 2 * sum(work.block_sizes(c))
    # the sweep is linear in the images; phase 1 too, but for G's stem at batch 1
    assert abs(two["flops"] - 2 * one["flops"]) < 0.01 * one["flops"]
    assert two["bytes"]["upsample"] == 2 * one["bytes"]["upsample"]
