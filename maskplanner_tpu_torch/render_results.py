"""Render predictions from saved .npy dumps: the port's
``render_results.py``.

    python -m maskplanner_tpu_torch.render_results --run RUN_DIR
        [--model last] [--split test] [--with_postprocess]
        [--align_stroke_ids] [--batch_grid] [--animated]
        [--movie_format gif|mp4] [--max_samples 4] [--coverage_meshes DIR
        --thickness_gt DIR --thickness_pred DIR]

Loads the run's frozen config and its ``results/*.npy`` dumps, extracts
stroke ids from the predicted masks, optionally runs the full segment
postprocess (filter -> Edmonds concat -> resample/smooth), and writes
side-by-side GT/pred PNGs under ``<run>/renders/`` (reference
render_results.py:163-350). Host code on numpy and matplotlib (``viz``);
mp4 needs OpenCV. The training driver runs it in a child process after a
run's final eval.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

# matplotlib first: where it is missing, the render fails before torch loads
from .viz import visualize_batch_grid, visualize_sample_pred_gt
from .postprocess import process_pred_stroke_masks_to_stroke_ids
from .postprocess.align import permute_and_align_stroke_ids_for_visualization
from .postprocess.segments import process_stroke_segments
from .utils.config import load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True)
    p.add_argument("--model", default="last")
    p.add_argument("--split", default="test", choices=["test", "train"])
    p.add_argument("--with_postprocess", action="store_true",
                   help="full segment concat + smoothing pipeline")
    p.add_argument("--align_stroke_ids", action="store_true",
                   help="align pred stroke ids to GT colors via mask matching")
    p.add_argument("--batch_grid", action="store_true")
    p.add_argument("--animated", action="store_true",
                   help="also save a progressive trajectory-reveal "
                        "animation per sample (reference "
                        "render_results.py movie mode, :255-275)")
    p.add_argument("--movie_format", default="gif",
                   choices=["gif", "mp4"],
                   help="animation container (mp4 via OpenCV)")
    p.add_argument("--max_samples", type=int, default=4)
    # paint-coverage face coloring (reference utils/visualize.py:654-721)
    p.add_argument("--coverage_meshes", default=None,
                   help="category root with <name>/<name>.obj meshes; "
                        "enables coverage-colored mesh figures")
    p.add_argument("--thickness_gt", default=None,
                   help="dir of GT per-face thickness CSVs (from "
                        "standalone/simulate_spray_thickness.py)")
    p.add_argument("--thickness_pred", default=None,
                   help="dir of predicted per-face thickness CSVs")
    p.add_argument("--coverage_percentile", type=int, default=10)
    return p.parse_args(argv)


def render_coverage(args, name, out_path):
    """Coverage-colored side-by-side GT/pred mesh figure for one item."""
    from .data.io import find_mesh, load_obj
    from .viz.render import visualize_coverage_mesh

    try:
        mesh = find_mesh(args.coverage_meshes, name)
    except FileNotFoundError:
        return None
    gt_csv = os.path.join(args.thickness_gt, f"{name}.txt")
    pred_csv = os.path.join(args.thickness_pred, f"{name}.txt")
    if not (os.path.isfile(gt_csv) and os.path.isfile(pred_csv)):
        return None
    verts, faces = load_obj(mesh)
    gt_t = np.genfromtxt(gt_csv, delimiter=";")
    pred_t = np.genfromtxt(pred_csv, delimiter=";")
    if gt_t.ndim == 2:
        gt_t, pred_t = gt_t[:, 1], pred_t[:, 1]
    return visualize_coverage_mesh(
        verts, faces, pred_t, gt_t, percentile=args.coverage_percentile,
        save_path=out_path)


def apply_retrocompat_defaults(config):
    for k, v in {"traj_with_equally_spaced_points": False,
                 "equal_in_3d_space": False,
                 "equal_spaced_points_distance": 0.05}.items():
        if k not in config:
            config[k] = v
    return config


def main(argv=None):
    args = parse_args(argv)
    config = apply_retrocompat_defaults(load_config(args.run))
    out_dir = os.path.join(args.run, "renders")
    os.makedirs(out_dir, exist_ok=True)

    pattern = os.path.join(args.run, "results",
                           f"{args.model}_{args.split}_batch*.npy")
    files = [f for f in sorted(glob.glob(pattern))
             if not f.endswith("_postprocessed.npy")]
    assert files, f"no dumps match {pattern} (run test_maskplanner.py --save)"

    for path in files:
        dump = np.load(path, allow_pickle=True).item()
        traj_pred = dump["traj_pred"]
        if dump.get("pred_stroke_masks") is not None:
            ids_pred = process_pred_stroke_masks_to_stroke_ids(
                dump["pred_stroke_masks"], dump["stroke_masks_scores"])
        else:
            # backbones without a stroke-mask head (segmentWise/pointWise
            # baselines etc.): render every segment under one stroke id
            ids_pred = np.zeros(traj_pred.shape[:2], np.int64)

        if args.align_stroke_ids:
            ids_pred = permute_and_align_stroke_ids_for_visualization(
                traj_pred, ids_pred, dump["traj"], dump["stroke_ids"],
                config)

        if args.with_postprocess:
            trajs, ids = process_stroke_segments(traj_pred, ids_pred, config)
        else:
            trajs = list(traj_pred)
            ids = list(ids_pred)

        B = min(len(trajs), args.max_samples)
        batch_tag = os.path.splitext(os.path.basename(path))[0]
        pcs = dump.get("point_cloud")
        for b in range(B):
            pc = pcs[b] if pcs is not None else np.zeros((1, 3))
            visualize_sample_pred_gt(
                pc, dump["traj"][b], dump["stroke_ids"][b],
                trajs[b], ids[b],
                os.path.join(out_dir, f"{batch_tag}_sample{b}.png"),
                title=str(dump["dirnames"][b]))
            if args.animated:
                from .viz.render import (
                    visualize_mesh_traj_animated)

                visualize_mesh_traj_animated(
                    pc, trajs[b], ids[b],
                    os.path.join(out_dir, f"{batch_tag}_sample{b}"
                                 f".{args.movie_format}"))
            if args.coverage_meshes and args.thickness_gt \
                    and args.thickness_pred:
                name = str(dump["dirnames"][b])
                cov = render_coverage(
                    args, name,
                    os.path.join(out_dir, f"{batch_tag}_sample{b}"
                                 f"_coverage.png"))
                if cov is not None:
                    print(f"  {name}: paint coverage {cov * 100:.1f}%")
        if args.batch_grid:
            visualize_batch_grid(
                [pcs[b] if pcs is not None else np.zeros((1, 3))
                 for b in range(B)],
                trajs[:B], ids[:B],
                os.path.join(out_dir, f"{batch_tag}_grid.png"))
        print(f"rendered {B} samples from {os.path.basename(path)} "
              f"-> {out_dir}")


if __name__ == "__main__":
    main()
