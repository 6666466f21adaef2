"""The benchmark of ``stylex_tpu_torch`` on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``benchmark/workloads/<cell>.json``: its configuration
(``benchmark/configs/<config>.json``), its traffic driver
(``benchmark/drivers/<driver>.py``) and the driver's parameters. The
metrics a cell reports are those ``BENCHMARK.json`` gives it: with
``--trace 0`` its end-to-end metrics, with ``--trace 1`` its per-layer
ones, each read from the run's record by ``benchmark/metrics/<name>.py``
(a reader that finds nothing returns None, and the metric is left out).
Nothing here names a cell or a metric: adding one is adding files and
entries.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, and with a trace
``breakdown``, then ``checks``: each number compared with its limit); the
same comparisons end standard error. The run exits non-zero, printing no
result, without a GPU or with fewer than the cell asks for, and when a JAX
module or the JAX package has been loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Context:
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    control: bool = False


def metric_names(spec: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with a trace its per-layer ones:
    those listing the cell, and those with no list whose ``moves`` metric
    (per-layer) the cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return [(m["name"], m["unit"]) for m in e2e]
    reported = {m["name"] for m in e2e}
    return [(m["name"], m["unit"]) for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(cell: str, seed: int, seconds: float, trace: bool, device, control=False):
    """The run's context: the cell, its configuration, and the driver."""
    from benchmark import common

    workload = common.load_json(common.workload_path(cell))
    workload["name"] = cell
    config = common.load_json(common.HERE / "configs" / f"{workload['config']}.json")
    driver = common.load_module(common.HERE / "drivers" / f"{workload['driver']}.py",
                                workload["driver"])
    return Context(workload, config, seed, seconds, trace, device, control), driver


def result_line(spec: dict, ctx: Context, record: dict, card: dict) -> dict:
    from benchmark import common

    metrics = {}
    for name, unit in metric_names(spec, ctx.workload["name"], ctx.trace):
        reader = common.load_module(common.HERE / "metrics" / f"{name}.py", name)
        value = reader.read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    checks = {name: {"value": value, "limit": limit} for name, value, limit in record["checks"]}
    correct = all(v["value"] <= v["limit"] for v in checks.values()) and record["failed"] == 0
    device = {k: card[k] for k in ("platform", "kind", "count")}
    device["memory_peak_bytes"] = int(record["memory_peak_bytes"])
    out = {"correct": correct, "attempted": int(record["attempted"]),
           "failed": int(record["failed"]), "metrics": metrics, "device": device}
    trace = record.get("trace")
    if ctx.trace and trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace.get("idle_gaps", [])}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import common

    common.set_cache_dirs()
    import torch

    workload = common.load_json(common.workload_path(args.workload))
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"benchmark: needs {workload['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = common.load_json(ROOT / "BENCHMARK.json")
    ctx, driver = prepare(args.workload, args.seed, args.seconds, bool(args.trace), device)
    record = driver.run(ctx)
    return finish(spec, ctx, record, common.card(device))


def finish(spec: dict, ctx: Context, record: dict, card: dict) -> int:
    from benchmark import common

    bad = common.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(spec, ctx, record, card)
    for k, v in (record.get("detail") or {}).items():
        print(f"detail {k}: {v}", file=sys.stderr)
    for k, v in (record.get("notes") or {}).items():
        print(f"note {k}: {v}", file=sys.stderr)
    for name, v in line["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(f"check failed: {line['failed']} (limit 0); correct: {line['correct']}",
          file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
