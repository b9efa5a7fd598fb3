"""One-shot serving CLI: OBJ meshes -> ``;``-separated X;Y;Z;A;B;C;strokeId
robot programs, from a run directory holding a port checkpoint.

    python -m maskplanner_tpu_torch.predict --run RUN_DIR --model last \\
        --meshes a.obj b.obj --out predicted_programs

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True, help="trained run directory")
    p.add_argument("--model", default="last",
                   help="checkpoint: best | last | intermediate_epochN")
    p.add_argument("--meshes", nargs="*", default=[],
                   help="OBJ mesh files to predict programs for")
    p.add_argument("--out", default="predicted_programs")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) | cpu")
    p.add_argument("--no_postprocess", action="store_true",
                   help="dump raw predicted segments instead of the "
                        "concatenated/resampled strokes")
    p.add_argument("--data_scale_factor", type=float, default=None)
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="forward compute dtype (only f32 is ported)")
    p.add_argument("--export", default=None,
                   help="not ported: ahead-of-time export of the forward")
    p.add_argument("--from_export", default=None,
                   help="not ported: serve from an exported forward")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.dtype != "f32":
        raise NotImplementedError("bf16 serving is not ported yet "
                                  "(ROADMAP.md, port queue)")
    if args.export or args.from_export:
        raise NotImplementedError("--export/--from_export are not ported yet "
                                  "(ROADMAP.md, port queue)")
    from .serve import Predictor

    pred = Predictor(args.run, model=args.model, device=args.device,
                     data_scale_factor=args.data_scale_factor)
    print(f"Loaded {args.model} (epoch {pred.epoch}) on {pred.device} | "
          f"pc_points={pred.pc_points} scale={pred.scale:.4f}")
    for mesh in args.meshes:
        name = os.path.splitext(os.path.basename(mesh))[0]
        out_path = os.path.join(args.out, f"{name}.txt")
        pred.save_program(mesh, out_path,
                          postprocess=not args.no_postprocess)
        rows = np.genfromtxt(out_path, delimiter=";", skip_header=1)
        n_strokes = len(np.unique(rows[:, 6])) if rows.size else 0
        print(f"{name}: {rows.shape[0]} poses, {n_strokes} strokes "
              f"-> {out_path}")
    if not args.meshes:
        print("nothing to do: pass --meshes")


if __name__ == "__main__":
    main()
