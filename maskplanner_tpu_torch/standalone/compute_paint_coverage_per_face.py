"""Paint coverage from per-face thickness CSVs.

The port's ``standalone/compute_paint_coverage_per_face.py``: directories
of ``;``-separated CSVs with one thickness a face-vertex (3·N rows for N
faces), a GT directory against one or more prediction directories, the
coverage of each item and each run's mean (``sim.coverage``).

    python -m \\
        maskplanner_tpu_torch.standalone.compute_paint_coverage_per_face \\
        --gt-run gt_dir --runs pred_dir1 pred_dir2 [--percentile 10]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..sim.coverage import coverage_for_pair, get_thicknesses_values_per_face


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--runs", default=[], nargs="+", required=True)
    p.add_argument("--gt-run", dest="gt_run", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--percentile", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """-> coverages (runs, items)."""
    args = parse_args(argv)
    percentile = args.percentile if args.percentile is not None else 10
    if args.percentile is None:
        print(f"WARNING! --percentile not set; defaulting to {percentile}")

    items = sorted(f for f in os.listdir(args.gt_run)
                   if os.path.isfile(os.path.join(args.gt_run, f)))
    coverages = [[] for _ in args.runs]
    for item in items:
        gt_faces = get_thicknesses_values_per_face(
            os.path.join(args.gt_run, item))
        if np.any(gt_faces < 0.0):
            raise ValueError(f"{item}: negative GT thickness")
        nonzero = ~np.isclose(gt_faces, 0.0)
        if not nonzero.any():
            raise ValueError(f"{item}: all-zero GT thickness")
        threshold = np.percentile(gt_faces[nonzero], percentile)
        print(f"\n--- Mesh: {item} | faces: {len(gt_faces)} | "
              f"zero-thickness: {int((~nonzero).sum())} | "
              f"p{percentile} threshold: {threshold:.2f}")
        for i, run in enumerate(args.runs):
            pred_path = os.path.join(run, item)
            if not os.path.isfile(pred_path):
                raise FileNotFoundError(f"missing {pred_path}")
            cov = coverage_for_pair(
                gt_faces, get_thicknesses_values_per_face(pred_path),
                percentile, threshold=threshold)
            print(f"> run {i} ---> coverage: {cov * 100:.2f}%")
            coverages[i].append(cov)

    coverages = np.array(coverages)
    print("\n======== FINAL RESULTS ========")
    print("RUNS ORDER:\n", args.runs)
    print(f"FINAL MEAN COVERAGES:\n {np.round(coverages.mean(1) * 100, 2)}%")
    print(f"FINAL ST.DEV COVERAGES:\n {np.round(coverages.std(1) * 100, 2)}%")
    return coverages


if __name__ == "__main__":
    main()
