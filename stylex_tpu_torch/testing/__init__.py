"""Scaffolding for the tests and ``chip_smoke.py``, kept out of the
package's own modules: none of them imports it (``tests/test_torch_isolation.py``
checks that the entry points load without it).

:mod:`.harness` holds the rank functions that a data-parallel group runs
against one process; they live in an importable module because
:func:`~stylex_tpu_torch.parallel.launch` spawns its ranks, and a spawned
rank imports the function it runs.
"""
