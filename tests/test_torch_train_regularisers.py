"""The port's train step with the contrastive D regulariser (``cl_reg``)
and with feature quantization plus attention (``fq_layers``,
``attn_layers``; the codebooks after their EMA update held too) against the
JAX package's, on the CPU. Method and tolerances as in
``test_torch_train_variants.py``."""

import pytest

from test_torch_train_variants import check_case, default_graph  # noqa: F401


@pytest.mark.parametrize("case", ["old-cl-reg", "old-fq-attn"])
def test_regularised_train_step_matches_jax(default_graph, case):
    check_case(case)
