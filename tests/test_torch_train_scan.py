"""The port's scan step (``fused_microbatches=False``: one micro-batch at
a time, gradients summed) against the JAX package's scan step, on the CPU:
the OLD arch, and the NEW arch with ``kl_rec_during_disc``. Method and
tolerances as in ``test_torch_train_variants.py``."""

import pytest

from test_torch_train_variants import check_case, default_graph  # noqa: F401


@pytest.mark.parametrize("case", ["old-scan", "new-scan-klrec"])
def test_scan_train_step_matches_jax(default_graph, case):
    check_case(case)
