"""One-shot serving CLI: OBJ meshes -> ``;``-separated X;Y;Z;A;B;C;strokeId
robot programs, from a run directory holding a port checkpoint.

    python -m maskplanner_tpu_torch.predict --run RUN_DIR --model last \\
        --meshes a.obj b.obj --out predicted_programs

    # write the eval forward as a torch.export program and exit (unless
    # --meshes)
    python -m maskplanner_tpu_torch.predict --run RUN_DIR --export fwd.pt2

    # serve from the program (weights in it; no model is traced again)
    python -m maskplanner_tpu_torch.predict --run RUN_DIR \\
        --from_export fwd.pt2 --meshes a.obj --out predicted_programs

It runs on the card unless ``--device cpu`` is given, in bf16 unless
``--dtype f32`` (or ``train``: the run's own dtype) is given, as the JAX
package's CLI. ``--platforms`` names the one device an export is traced
for (default: ``--device``); a ``torch.export`` program holds one device,
so a second one raises.
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
    p.add_argument("--dtype", choices=["bf16", "f32", "train"],
                   default="bf16",
                   help="forward compute dtype: bf16 (the serving default), "
                        "f32, or 'train' for the run's training dtype")
    p.add_argument("--export", default=None,
                   help="write the eval forward as a torch.export program "
                        "and exit (unless --meshes)")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="the one device (cuda | cpu) --export traces for; "
                        "default --device")
    p.add_argument("--from_export", default=None,
                   help="serve the forward from an exported program")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.platforms is not None and len(args.platforms) != 1:
        raise ValueError(f"--platforms takes one device (cuda or cpu), got "
                         f"{args.platforms}: a torch.export program is "
                         f"traced for one device (ROADMAP.md)")
    from .serve import Predictor

    pred = Predictor(args.run, model=args.model, device=args.device,
                     data_scale_factor=args.data_scale_factor,
                     compute_dtype=None if args.dtype == "train"
                     else args.dtype)
    dtype = "bf16" if pred.config["model"].get("bf16") else "f32"
    print(f"Loaded {args.model} (epoch {pred.epoch}) on {pred.device} in "
          f"{dtype} | pc_points={pred.pc_points} scale={pred.scale:.4f}")
    if args.export:
        device = args.platforms[0] if args.platforms else pred.device
        blob = pred.export_compiled(args.export, device=device)
        print(f"exported the forward -> {args.export} ({len(blob)} bytes, "
              f"device {device}, {dtype})")
    if args.from_export:
        pred.serve_exported(args.from_export)
        print(f"serving the forward from {args.from_export}")
    for mesh in args.meshes:
        name = os.path.splitext(os.path.basename(mesh))[0]
        out_path = os.path.join(args.out, f"{name}.txt")
        pred.save_program(mesh, out_path,
                          postprocess=not args.no_postprocess)
        rows = np.genfromtxt(out_path, delimiter=";", skip_header=1)
        n_strokes = len(np.unique(rows[:, 6])) if rows.size else 0
        print(f"{name}: {rows.shape[0]} poses, {n_strokes} strokes "
              f"-> {out_path}")
    if not args.meshes and not args.export:
        print("nothing to do: pass --meshes and/or --export")


if __name__ == "__main__":
    main()
