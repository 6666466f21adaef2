"""The port's train step against the JAX package's with the step's options
on, on the CPU: DiffAugment with the JAX draws, top-k, the relativistic D
loss and ``kl_rec_during_disc`` (NEW arch); the dual contrastive loss with
every micro-batch on the encoder path (OLD arch). Step 0, so GP and PL
run. Same method and tolerances as ``test_torch_train.py``."""

import pytest

from test_torch_train import _setup, compare_step

CASES = {
    "new-aug-topk-rel-klrec": ("new", dict(aug_prob=0.5, aug_types=("translation", "cutout", "color"),
                                           top_k_training=True, rel_disc_loss=True,
                                           kl_rec_during_disc=True)),
    "old-dual-contrast-all-encoder": ("old", dict(dual_contrast_loss=True,
                                                  alternating_training=False)),
}


@pytest.fixture(scope="module")
def literal_resample():
    mp = pytest.MonkeyPatch()
    mp.setenv("STYLEX_TPU_NO_FUSED_UPCONV", "1")
    yield
    mp.undo()


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_options_match_jax(literal_resample, case):
    arch, overrides = CASES[case]
    metrics = compare_step(_setup(arch, **overrides), 0)
    assert float(metrics["gp"]) > 0
