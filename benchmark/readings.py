"""The numbers a cell's correctness check compares, over many seeds in one
process: what the limits in ``benchmark/workloads/<cell>.json`` are set
from. Each seed runs the cell's set-up and a window of one unit (one
extraction call, one train step), compares with the reference, and with
``--control`` also puts the reference at the precision below the
configuration's (``reference.ops.control_for``) in the program's place.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--control]
        [--out build/readings.jsonl]

Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import common
    from benchmark import run as bench

    common.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, driver = bench.prepare(args.workload, seed, 0.0, False, device, args.control)
        rec = driver.run(ctx)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "numbers": rec["numbers"], "raw": rec.get("raw"),
                           "control": rec.get("control"), "failed": rec["failed"],
                           "detail": rec.get("detail"),
                           "card": common.card(device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del rec
        common.free_device_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
