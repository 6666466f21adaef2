"""The port's train step on its default graph and with the model and step
options, against the JAX package's, on the CPU.

Same method and tolerances as ``test_torch_train.py`` (losses rtol 1e-4,
gradients 1e-4 x max|g| per tree), step 0, so GP and PL run:

* the default step, with ``STYLEX_TPU_NO_FUSED_UPCONV`` unset: both
  packages take the fused resample graph (the JAX step reads the policy
  when it is traced, inside this environment);
* ``cl_reg`` (the JAX step's contrastive-view draws replayed);
* ``fq_layers`` with attention, the codebooks after their EMA update held
  too;
* the scan step (``fused_microbatches=False``), OLD arch, and the NEW arch
  with ``kl_rec_during_disc``.

This file holds the default steps; ``test_torch_train_scan.py`` and
``test_torch_train_regularisers.py`` run the other cases. Here too: the
port's scan step against its fused one from the same state and draws, and
``remat`` against no ``remat``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from stylex_tpu_torch.config import ModelConfig, TrainConfig
from stylex_tpu_torch.models.stylex import build_stylex
from stylex_tpu_torch.models.classifiers import build_classifier
from stylex_tpu_torch.models.lpips import init_lpips_params
from stylex_tpu_torch.train import create_train_state, draw_step, make_train_step

from test_torch_train import TC, TINY, _AddGrad, _setup, compare_step

torch.set_num_threads(2)

CASES = {
    "old-default": ("old", {}, {}),
    "new-default": ("new", {}, {}),
    "old-cl-reg": ("old", {}, dict(cl_reg=True)),
    "old-fq-attn": ("old", dict(fq_layers=(2,), fq_dict_size=32, attn_layers=(2,)), {}),
    "old-scan": ("old", {}, dict(fused_microbatches=False)),
    "new-scan-klrec": ("new", {}, dict(fused_microbatches=False, kl_rec_during_disc=True)),
}


@pytest.fixture
def default_graph(monkeypatch):
    monkeypatch.delenv("STYLEX_TPU_NO_FUSED_UPCONV", raising=False)


def check_case(case):
    """One step of ``CASES[case]`` against the JAX step."""
    arch, model, overrides = CASES[case]
    p = _setup(arch, model=model, **overrides)
    metrics = compare_step(p, 0)
    assert float(metrics["gp"]) > 0
    if "cl_reg" in overrides:
        assert float(metrics["cr_loss"]) > 0
    if "fq_layers" in model:
        assert float(metrics["q_loss"]) > 0


@pytest.mark.parametrize("case", ["old-default", "new-default"])
def test_default_train_step_matches_jax(default_graph, case):
    check_case(case)


def _port_step(cfg, tc, seed=0):
    """One port step from a seeded model; returns (metrics, gradients per
    parameter, the state dict after the step)."""
    model = build_stylex(cfg, seed=seed, device="cpu")
    state = create_train_state(model, cfg, tc)
    state.g_opt = _AddGrad([p for g in state.g_opt.param_groups for p in g["params"]])
    state.d_opt = _AddGrad(list(model.D.parameters()))
    state.pl_mean = torch.tensor(0.5)
    clf = build_classifier("mobilenet", cfg.image_size, seed=1, device="cpu")
    clf.net.requires_grad_(False)
    step = make_train_step(cfg, tc, clf.classify_images, init_lpips_params(device="cpu"))
    rng = np.random.RandomState(4)
    batch = {k: rng.rand(2, 2, 16, 16, 3).astype(np.float32)
             for k in ("d_real", "d_enc", "g_imgs")}
    draws = draw_step(torch.Generator().manual_seed(5), cfg, tc, tc.batch_size,
                      model.num_layers, tc.aug_prob, 0)
    before = copy.deepcopy(model.state_dict())
    metrics = step(state, batch, draws)
    after = model.state_dict()
    names = [n for n, _ in model.named_parameters()]
    return metrics, {k: after[k] - before[k] for k in names}, after


def _assert_grads_close(got, want, rel):
    for tree in ("encoder.", "S.", "G.", "D."):
        keys = [k for k in want if k.startswith(tree)]
        scale = max(float(want[k].abs().max()) for k in keys)
        for k in keys:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=rel * scale + 1e-12, err_msg=k)


def test_scan_step_matches_fused_step(default_graph):
    """The same state, batch and draws through both steps, with the
    contrastive and quantize losses, augmentation and top-k on."""
    cfg = ModelConfig(**TINY, fq_layers=(2,), fq_dict_size=32)
    tc = TrainConfig(**{**TC, "aug_prob": 0.5}, cl_reg=True)
    m_f, g_f, sd_f = _port_step(cfg, tc)
    m_s, g_s, sd_s = _port_step(cfg, dataclasses.replace(tc, fused_microbatches=False))
    for k, v in m_f.items():
        np.testing.assert_allclose(float(m_s[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    _assert_grads_close(g_s, g_f, 1e-4)
    book = "D.quantize_blocks.1.codebook"
    np.testing.assert_allclose(sd_s[book].numpy(), sd_f[book].numpy(), rtol=1e-5, atol=1e-6)


def test_remat_gives_the_same_gradients(default_graph):
    """``remat`` recomputes each G block in the backward pass, the
    path-length penalty's double backward included: same gradients."""
    cfg = ModelConfig(**TINY, attn_layers=(1,))
    tc = TrainConfig(**TC)
    m_a, g_a, _ = _port_step(cfg, tc)
    m_b, g_b, _ = _port_step(dataclasses.replace(cfg, remat=True), tc)
    assert float(m_a["gp"]) > 0 and float(m_a["pl_mean"]) != 0.5
    for k, v in m_a.items():
        np.testing.assert_allclose(float(m_b[k]), float(v), rtol=1e-6, atol=1e-7, err_msg=k)
    _assert_grads_close(g_b, g_a, 1e-6)


def test_remat_recomputes_the_blocks(default_graph, monkeypatch):
    """Under ``remat`` a backward pass runs each G block's forward again."""
    from stylex_tpu_torch.models import generator as gen

    calls = []
    forward = gen.GeneratorBlock.forward
    monkeypatch.setattr(gen.GeneratorBlock, "forward",
                        lambda self, *a: calls.append(1) or forward(self, *a))
    for remat, want in ((False, 3), (True, 6)):
        cfg = ModelConfig(**TINY, remat=remat)
        model = build_stylex(cfg, seed=0, device="cpu")
        w = torch.randn(2, model.num_layers, cfg.latent_dim, requires_grad=True)
        calls.clear()
        rgb, _ = model.generate(w, torch.rand(1, 16, 16, 1))
        rgb.sum().backward()
        assert len(calls) == want
