"""The port's eval entry point (``test_maskplanner.py`` of the JAX package).

    python -m maskplanner_tpu_torch.test_maskplanner --run RUN_DIR \\
        --model last [--target CAT] [--data_scale_factor F] \\
        [--renormalize_data_to_default] [--save] [--split test]

It loads the run's frozen config and the asked-for port checkpoint (best |
last | intermediate_epochN), optionally evaluates another category
(cross-category transfer, with the outputs renormalised to its default
scale for comparable chamfer metrics), runs ``train.loop.evaluate`` with
the run's ``eval_metrics`` and the single-sample latency, and with
``--save`` writes the ``.npy`` dumps under ``RUN_DIR/results/``. It runs on
the card unless ``--device cpu`` is given (``cuda`` without a card raises),
in the run's own dtype unless ``--dtype bf16|f32`` is given.
"""
from __future__ import annotations

import argparse
import os

from .convert import checkpoint_name, checkpoint_path, load_checkpoint
from .data.dataset import DataLoader, PaintDataset
from .losses import LossHandler
from .metrics import MetricsHandler
from .models import get_model
from .serve import resolve_device
from .train import forward
from .train.loop import evaluate
from .utils import create_dirs, set_seed
from .utils.config import apply_retrocompat_defaults, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True, help="run directory")
    p.add_argument("--model", default="last",
                   help="checkpoint: best | last | intermediate_epochN")
    p.add_argument("--target", default=None,
                   help="override evaluation category (transfer testing)")
    p.add_argument("--data_scale_factor", type=float, default=None)
    p.add_argument("--renormalize_data_to_default", action="store_true",
                   help="renormalize outputs to the target category's "
                        "default scale for comparable PCD")
    p.add_argument("--save", action="store_true", help="save .npy dumps")
    p.add_argument("--split", default="test", choices=["test", "train"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) | cpu")
    p.add_argument("--dtype", choices=["bf16", "f32", "train"],
                   default="train",
                   help="forward compute dtype: the run's own (train), "
                        "bf16 or f32")
    return p.parse_args(argv)


def main(argv=None):
    """Evaluate; returns (loss, terms, metrics)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = apply_retrocompat_defaults(load_config(args.run))
    if args.dtype != "train":
        config["model"]["bf16"] = args.dtype == "bf16"
    set_seed(config.get("seed"))

    renorm_cfg = {}
    if args.target:
        # cross-category transfer (reference test_maskplanner.py:109-155)
        default_scale = None
        if args.renormalize_data_to_default:
            probe = config.copy()
            probe["dataset"] = [args.target]
            probe["data_scale_factor"] = None
            default_scale = PaintDataset(probe, split="test").scale
        config["dataset"] = [args.target]
        if args.data_scale_factor is not None:
            config["data_scale_factor"] = args.data_scale_factor
        if args.renormalize_data_to_default and default_scale:
            renorm_cfg = {"active": True,
                          "from": float(config.get("data_scale_factor")
                                        or default_scale),
                          "to": float(default_scale)}

    dataset = PaintDataset(config, split=args.split,
                           size=config.get("test_dataset_size"))
    batch_size = args.batch_size or min(int(config["batch_size"]),
                                        len(dataset))
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)

    name = checkpoint_name(args.model)
    if not os.path.isfile(checkpoint_path(args.run, name)):
        raise FileNotFoundError(f"checkpoint {name} not found in {args.run}")
    model = get_model(config, device=device)
    epoch = load_checkpoint(args.run, name, model)
    print(f"Loaded {name} (epoch {epoch}) on {device}")

    handler = LossHandler(config["loss"], config)
    weights = handler.init_weights()
    metrics_handler = MetricsHandler(config, config.get("eval_metrics") or [],
                                     renormalize_output_config=renorm_cfg)
    save_dir = (create_dirs(os.path.join(args.run, "results"))
                if args.save else None)
    loss, terms, metrics, _ = evaluate(
        model, loader, handler, weights, metrics_handler, device,
        save=args.save, save_dir=save_dir, split=args.split,
        eval_ckpt=args.model, forward=forward)

    print(f"{args.split} loss: {loss:.9g}")
    for k, v in terms.items():
        print(f"  {k}: {v:.9g}")
    for k, v in metrics.items():
        print(f"  {k}: {v:.9g}")
    return loss, terms, metrics


if __name__ == "__main__":
    main()
