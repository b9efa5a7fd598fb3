"""Export a run's eval dumps as robot programs for the spray simulator.

The port's ``standalone/from_pred_to_offline_v2.py``: the ``.npy`` dumps
that a run's final eval or the eval CLI writes under ``<run>/results/``
(``<model>_<split>_batch*.npy``) -> one ``<name>.txt`` program per item
(``;``-separated X;Y;Z;A;B;C;strokeId with Euler angles) for the GT and
the prediction, denormalized to the workspace scale.

    python -m maskplanner_tpu_torch.standalone.from_pred_to_offline_v2 \\
        --run RUN_DIR [--output_dir predicted_programs] [--postprocess]
        [--segments_filtering_only] [--custom_data_scale_factor F]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..data.io import (get_dataset_downscale_factor, get_dataset_name,
                       orientnorm_to_euler, save_traj_file)
from ..data.pointcloud import denormalize_traj, get_dim_traj_points
from ..postprocess import process_pred_stroke_masks_to_stroke_ids
from ..postprocess.segments import process_stroke_segments
from ..utils.config import load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True)
    p.add_argument("--output_dir", default="predicted_programs")
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--model", default="last")
    p.add_argument("--postprocess", action="store_true")
    p.add_argument("--segments_filtering_only", action="store_true")
    p.add_argument("--no_interpolation", action="store_true")
    p.add_argument("--cover_all", action="store_true",
                   help="split off-Edmonds-path segments into sub-strokes "
                        "instead of dropping them")
    p.add_argument("--custom_data_scale_factor", type=float, default=None)
    p.add_argument("--confidence_threshold", type=float, default=0.5,
                   help="stroke-mask confidence filter")
    p.add_argument("--force_overwrite", action="store_true")
    return p.parse_args(argv)


def _to_points(traj_rows, ids_rows, extra_data):
    """Per-sample segment rows (−100 padded) -> (points, per-point ids)."""
    outdim = get_dim_traj_points(extra_data)
    valid = ~np.all(traj_rows == -100.0, axis=-1)
    rows, ids = traj_rows[valid], np.asarray(ids_rows)[valid]
    lam = rows.shape[-1] // outdim
    return rows.reshape(-1, outdim), np.repeat(ids, lam)


def main(argv=None):
    args = parse_args(argv)
    config = load_config(args.run)
    category = get_dataset_name(config["dataset"])
    extra_data = config["extra_data"]
    if config["normalization"] != "per-dataset":
        raise ValueError(f"the export needs per-dataset normalization, the "
                         f"run has {config['normalization']!r}")
    scale = (args.custom_data_scale_factor
             or config.get("data_scale_factor")
             or get_dataset_downscale_factor(category) or 1.0)

    files = sorted(glob.glob(os.path.join(
        args.run, "results", f"{args.model}_{args.split}_batch*.npy")))
    if not files:
        raise FileNotFoundError(f"no dumps found in {args.run}/results")
    gt_dir = os.path.join(args.output_dir, f"gt_{category}")
    pred_dir = os.path.join(args.output_dir, f"pred_{category}")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(pred_dir, exist_ok=True)

    for path in files:
        dump = np.load(path, allow_pickle=True).item()
        ids_pred = process_pred_stroke_masks_to_stroke_ids(
            dump["pred_stroke_masks"], dump["stroke_masks_scores"],
            confidence_threshold=args.confidence_threshold)
        if args.postprocess:
            trajs, out_ids = process_stroke_segments(
                dump["traj_pred"], ids_pred, config,
                segments_filtering_only=args.segments_filtering_only,
                no_interpolation=args.no_interpolation,
                cover_all=args.cover_all)
            if args.segments_filtering_only:
                pairs = [_to_points(trajs[b], out_ids[b], extra_data)
                         for b in range(len(trajs))]
            else:
                pairs = list(zip(trajs, out_ids))
        else:
            pairs = [_to_points(dump["traj_pred"][b], ids_pred[b], extra_data)
                     for b in range(len(ids_pred))]

        for b, name in enumerate(dump["dirnames"]):
            gt = _to_points(dump["traj"][b], dump["stroke_ids"][b],
                            extra_data)
            for (pts, ids), out_dir in ((gt, gt_dir), (pairs[b], pred_dir)):
                out_path = os.path.join(out_dir, f"{name}.txt")
                if os.path.isfile(out_path) and not args.force_overwrite:
                    continue
                # the centroid is unknown without the source mesh: the
                # program is exported around the origin
                pts = denormalize_traj(np.asarray(pts, np.float64),
                                       centroid=np.zeros(3), scale=scale,
                                       weight_orient=config["weight_orient"])
                euler = orientnorm_to_euler(pts[:, 3:6])
                rows = np.concatenate(
                    [pts[:, :3], euler,
                     np.asarray(ids, np.float64)[:, None]], axis=1)
                save_traj_file(rows, out_path, kind="euler")
        print(f"exported batch {os.path.basename(path)}")
    print(f"programs written to {gt_dir} and {pred_dir}")
    return gt_dir, pred_dir


if __name__ == "__main__":
    main()
