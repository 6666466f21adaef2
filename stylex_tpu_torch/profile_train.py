"""Device-time breakdown of training steps on the GPU.

    python -m stylex_tpu_torch.profile_train [--dtype float32] [--out FILE]

Builds the ``Trainer`` at the CLI defaults (64px, capacity 16, OLD arch,
ResNet-18, batch 4 x 8 micro-batches, the 512-image synthetic set, random
weights from seed 0; no PL before step 5000, so none here; the default
resample graph, fused, or the literal one with
``STYLEX_TPU_NO_FUSED_UPCONV=1`` in the environment), takes 4
warm-up steps (step 0 saves and evaluates), times one GP cycle of 4 steps
(``gp_every``: one GP step, three plain ones) with CUDA events, then traces
the next cycle with ``torch.profiler``. Prints ms per step, the device time
per step by kernel kind and by kernel name, the device's busy share of the
traced window and the package's own kernels' share. Checkpoints and grids
go to a temporary directory under ``--workdir`` that is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch

CYCLE = 4  # TrainConfig.gp_every


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--workdir", default="chiprun_out")
    p.add_argument("--out", default=None, help="write the table as JSON here")
    args = p.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from stylex_tpu_torch.config import ModelConfig, TrainConfig
    from stylex_tpu_torch.profile_sweep import by_kind, card_line, device_summary, print_summary
    from stylex_tpu_torch.train.trainer import Trainer

    Path(args.workdir).mkdir(parents=True, exist_ok=True)
    base = tempfile.mkdtemp(prefix="profile_train_", dir=args.workdir)
    tc = TrainConfig(save_every=1000, evaluate_every=1000, compute_dtype=args.dtype)
    trainer = Trainer(name="profile", base_dir=base, model_cfg=ModelConfig(), train_cfg=tc,
                      classifier_name="resnet", seed=0)
    try:
        trainer.set_data_src(dataset_name="synthetic")
        for _ in range(CYCLE):
            trainer.train()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CYCLE):
            trainer.train()
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / CYCLE
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(CYCLE):
                trainer.train()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        trainer.close()
        shutil.rmtree(base, ignore_errors=True)

    rows, device_ms, busy_share, ours = device_summary(prof, CYCLE, window_ms)
    card = card_line()
    batch = tc.batch_size * tc.gradient_accumulate_every
    print(f"{card} | {args.dtype} | batch {tc.batch_size} x {tc.gradient_accumulate_every}")
    print(f"step: {step_ms:.2f} ms (CUDA events, mean of one GP cycle of {CYCLE} steps) = "
          f"{batch / step_ms * 1e3:.1f} images/s; traced device time {device_ms:.2f} ms/step "
          f"over {sum(r['calls_per_rep'] for r in rows):.0f} device events per step; "
          f"device busy {busy_share:.3f} of the traced window ({window_ms / CYCLE:.2f} ms/step "
          f"traced)")
    print_summary(rows, device_ms, ours, "step", args.top)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, dtype=args.dtype, step_ms=step_ms, device_ms_per_step=device_ms,
            busy_share=busy_share, traced_ms_per_step=window_ms / CYCLE,
            ours_ms_per_step=ours, by_kind=by_kind(rows), rows=rows,
        ), indent=1))


if __name__ == "__main__":
    main()
