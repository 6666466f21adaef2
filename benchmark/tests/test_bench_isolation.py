"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name, and the reference imports nothing of the
program under test."""

import ast
import json
import os
import subprocess
import sys
import types

from benchmark import common

from conftest import ROOT

BENCH = ROOT / "benchmark"


def test_a_cpu_run_of_every_cell_loads_no_jax():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "from conftest import tiny_context\n"
        "from benchmark import common, run as bench\n"
        "import torch\n"
        "for cell in ('plant64.attfind', 'plant64.train'):\n"
        "    ctx, driver = tiny_context(cell)\n"
        "    rec = driver.run(ctx)\n"
        "    bench.result_line(common.load_json(bench.ROOT / 'BENCHMARK.json'), ctx, rec,\n"
        "                      common.card(torch.device('cpu')))\n"
        "print(json.dumps(common.forbidden_modules()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names():
    fake = "stylex_tpu.models"
    sys.modules["stylex_tpu_torch_lookalike"] = types.ModuleType("stylex_tpu_torch_lookalike")
    try:
        before = common.forbidden_modules()
        sys.modules[fake] = types.ModuleType(fake)
        assert fake in common.forbidden_modules()
        assert "stylex_tpu_torch_lookalike" not in common.forbidden_modules()
    finally:
        sys.modules.pop(fake, None)
        sys.modules.pop("stylex_tpu_torch_lookalike", None)
    assert fake not in before


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_only_torch():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        assert _imports(f) <= {"__future__", "contextlib", "contextvars", "math", "typing",
                               "torch"}, f


def test_nothing_under_the_benchmark_imports_jax_or_the_jax_package():
    for f in BENCH.rglob("*.py"):
        assert not _imports(f) & set(common.FORBIDDEN), f
