"""Run the spray-deposition stand-in over exported robot programs.

The port's ``standalone/simulate_spray_thickness.py``: the ``<name>.txt``
programs that ``from_pred_to_offline_v2`` writes, with the category's
meshes -> per-face-vertex thickness CSVs (3 rows a face) for
``compute_paint_coverage_per_face``.

    python -m maskplanner_tpu_torch.standalone.simulate_spray_thickness \\
        --programs programs/gt_cat programs/pred_cat \\
        --meshes $PAINTNET_ROOT/<category> --out thickness/
"""
from __future__ import annotations

import argparse
import glob
import os

from ..data.io import find_mesh
from ..sim import simulate_program


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--programs", nargs="+", required=True,
                   help="dirs of <name>.txt robot programs")
    p.add_argument("--meshes", required=True,
                   help="category root holding <name>/<name>.obj "
                        "(or flat <name>.obj)")
    p.add_argument("--out", required=True)
    p.add_argument("--sigma_deg", type=float, default=12.0)
    p.add_argument("--cone_deg", type=float, default=30.0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for prog_dir in args.programs:
        out_dir = os.path.join(args.out, os.path.basename(
            os.path.normpath(prog_dir)))
        os.makedirs(out_dir, exist_ok=True)
        programs = sorted(glob.glob(os.path.join(prog_dir, "*.txt")))
        if not programs:
            raise FileNotFoundError(f"no programs in {prog_dir}")
        for prog in programs:
            name = os.path.splitext(os.path.basename(prog))[0]
            simulate_program(find_mesh(args.meshes, name), prog,
                             os.path.join(out_dir, f"{name}.txt"),
                             sigma_deg=args.sigma_deg,
                             cone_deg=args.cone_deg)
            print(f"simulated {name} -> {out_dir}")
    print(f"thickness CSVs written under {args.out}")


if __name__ == "__main__":
    main()
