"""Apply the full postprocess to saved predictions for offline metrics.

The port's ``standalone/from_pred_to_postprocess_pred.py``: the ``.npy``
dumps that a run's final eval or the eval CLI writes under
``<run>/results/`` (``<model>_<split>_batch*.npy``) -> the postprocessed
predictions beside each, ``<model>_<split>_batch<i>_postprocessed.npy``.

    python -m maskplanner_tpu_torch.standalone.from_pred_to_postprocess_pred \\
        --run RUN_DIR [--split test] [--model last] [--cover_all]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..postprocess import process_pred_stroke_masks_to_stroke_ids
from ..postprocess.segments import process_stroke_segments
from ..utils.config import load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True)
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--model", default="last")
    p.add_argument("--cover_all", action="store_true",
                   help="split off-Edmonds-path segments into sub-strokes "
                        "instead of dropping them")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = load_config(args.run)
    files = sorted(glob.glob(os.path.join(
        args.run, "results", f"{args.model}_{args.split}_batch*.npy")))
    files = [f for f in files if not f.endswith("_postprocessed.npy")]
    assert files, f"no dumps found under {args.run}/results"

    for path in files:
        dump = np.load(path, allow_pickle=True).item()
        ids_pred = process_pred_stroke_masks_to_stroke_ids(
            dump["pred_stroke_masks"], dump["stroke_masks_scores"])
        trajs, ids = process_stroke_segments(dump["traj_pred"], ids_pred,
                                             config,
                                             cover_all=args.cover_all)
        out = {
            "dirnames": dump["dirnames"],
            "traj_pred_postprocessed": np.array(trajs, dtype=object),
            "stroke_ids_pred_postprocessed": np.array(ids, dtype=object),
            "n_strokes": dump["n_strokes"],
        }
        out_path = path.replace(".npy", "_postprocessed.npy")
        np.save(out_path, out)
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
