"""Counterfactual-FID runner: the counterpart of the repository's
``scripts/run_counterfactual.py`` for the port.

    python -m stylex_tpu_torch.run_counterfactual --name plants --models-dir models \\
        --attfind-dir ./attfind_results --classifier-name mobilenet \\
        --classifier-path classifier.msgpack --k 5

Loads a trained StylEx (``--name``: the port's ``model_<n>.pt`` or the JAX
package's ``model_<n>.ckpt``, through ``Trainer.load(inference=True,
ship_ema=False)``; or ``--checkpoint`` with ``--config``) and the AttFind
outputs of ``run_attfind`` in ``--attfind-dir`` (``style_change_records``
as ``.hdf5`` or ``.npz``, and ``top_styles.json``), then computes
FID(original, generated) and FID(original, counterfactual top-1..k) with
compounding shifts (``eval.counterfactual.fid_topk``) and writes
``fid_results.csv``. The features are InceptionV3's with the weights named
by ``STYLEX_TPU_INCEPTION``, else the seeded AlexNet. Runs on the GPU
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def find_records(attfind_dir: Path) -> Path:
    """``style_change_records.hdf5`` in ``attfind_dir``, else its ``.npz``."""
    for suffix in (".hdf5", ".npz"):
        path = attfind_dir / f"style_change_records{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no style_change_records.hdf5 or .npz in {attfind_dir}")


def main(argv=None) -> list:
    from stylex_tpu_torch.replay_results import add_model_args, load_model

    p = argparse.ArgumentParser(description="StylEx counterfactual FID (top-k), PyTorch")
    add_model_args(p)
    p.add_argument("--attfind-dir", required=True,
                   help="folder holding style_change_records.hdf5 (or .npz) and top_styles.json")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--shift-size", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--csv", default=None, help="output CSV (default <attfind-dir>/fid_results.csv)")
    args = p.parse_args(argv)

    from stylex_tpu_torch.attfind import load_records
    from stylex_tpu_torch.eval.counterfactual import fid_topk

    att = Path(args.attfind_dir)
    records = load_records(str(find_records(att)))
    ranked = [tuple(x) for x in json.loads((att / "top_styles.json").read_text())["ranked"]]
    ranked = ranked[: args.k]
    print(f"records: {records.style_change.shape[0]} images; top-{len(ranked)} styles: {ranked}")

    loaded = load_model(args, ship_ema=False)
    if loaded is None:
        p.error("a model is needed: --name, or --checkpoint with --config")
    model, clf = loaded
    csv_path = args.csv or str(att / "fid_results.csv")
    t0 = time.perf_counter()
    fids = fid_topk(model, clf.classify_images, records, ranked, k=len(ranked),
                    shift_size=args.shift_size, batch_size=args.batch_size, csv_path=csv_path)
    print(f"fid_topk ({len(ranked) + 1} FID passes) in {time.perf_counter() - t0:.1f}s "
          f"-> {csv_path}")
    print("FID(original, generated)      =", round(fids[0], 4))
    for i, f in enumerate(fids[1:], 1):
        print(f"FID(original, counterfactual top-{i}) =", round(f, 4))
    return fids


if __name__ == "__main__":
    main()
