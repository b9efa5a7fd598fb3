"""The port's MaskPlanner training entry point
(``train_maskplanner.py`` of the JAX package).

    python -m maskplanner_tpu_torch.train_maskplanner \\
        config=[maskplanner,windows_v2,longx_v2] seed=1

The same ``config=[...] k=v`` contract: config -> seed -> run dir and frozen
config -> data -> model -> Adam and the LR milestones -> the epoch loop,
with the eval loss every ``eval_freq`` epochs, then the PSACD curriculum
and the delayed loss activations. At every eval it writes
``last_checkpoint`` (``convert.save_checkpoint``), copies it to
``best_model`` when the eval loss improves and, under
``save_intermediate_models``, to ``intermediate_checkpoint_epoch{N}`` every
``save_intermediate_models_freq`` epochs; the port's ``Predictor`` serves
any of them. ``no_save`` writes none. It runs on the card unless ``device=cpu`` is given;
``device=cuda`` without a card raises. With ``model.pretrained`` (the
default) and ``model.norm=batch`` it warm-starts the encoder from the
original repository's ShapeNet checkpoint when the file is there. Under
``model.bf16=true`` the model trains in bf16 (the JAX package's dtype
rules; ``models.pointnet2``) on f32 parameters: the frozen config keeps the
flag, the checkpoints hold the f32 parameters, and a ``Predictor`` of the
run serves it in bf16.

Not ported yet (each raises when its config asks for it): resume, the
adversarial losses, the device-resident epoch (``device_dataset=true``),
warm starts from a pretrained run (``model.pretrained_custom``). The eval
metrics and the final ``.npy`` prediction dumps are skipped, with a
notice.
"""
from __future__ import annotations

import json
import os
import time

import torch

from .convert import copy_checkpoint, load_shapenet_encoder, save_checkpoint
from .data.dataset import DataLoader, PaintDataset
from .losses import LossHandler
from .models import get_model
from .serve import resolve_device
from .train import (PSACDScheduler, apply_delayed_activations,
                    batch_to_device, eval_step, make_lr_scheduler,
                    make_optimizer, train_step)
from .utils import create_dirs, get_run_name, set_seed
from .utils.args import load_args
from .utils.config import save_config


def get_output_dir(config):
    """Priority: config.output_dir > $WORKDIR > ./runs."""
    return config.get("output_dir") or os.environ.get("WORKDIR") or "runs"


def _refuse_unported(config) -> None:
    if config.get("resume"):
        raise NotImplementedError("resume is not ported yet (ROADMAP.md, "
                                  "port queue)")
    if any(n in ("discriminator", "wdiscriminator") for n in config["loss"]):
        raise NotImplementedError("the adversarial losses are not ported yet "
                                  "(ROADMAP.md, Queue 1)")
    if str(config.get("device_dataset", "auto")).lower() == "true":
        raise NotImplementedError("the device-resident epoch "
                                  "(device_dataset=true) is not ported yet "
                                  "(ROADMAP.md, port queue)")
    if config["model"].get("pretrained_custom"):
        raise NotImplementedError("model.pretrained_custom warm starts are "
                                  "not ported yet (ROADMAP.md, port queue)")


def warm_start_encoder(model, config) -> list[str] | None:
    """The ShapeNet encoder warm start (``model.pretrained``): sa1..sa3 from
    ``model.pretrained_path`` or ``pretrained_models/pointnet2_cls_ssg.pth``
    -> the loaded keys. Under any norm but ``batch`` (the checkpoint's
    running statistics have no target), or without the file, it warns and
    returns None."""
    pth = config["model"].get("pretrained_path") or os.path.join(
        "pretrained_models", "pointnet2_cls_ssg.pth")
    enc_norm = config["model"].get("norm") or "batch"
    if not os.path.isfile(pth):
        print(f"WARNING: model.pretrained set but {pth} not found; encoder "
              f"starts from random init")
        return None
    if enc_norm != "batch":
        print(f"WARNING: torch encoder warm start ({pth}) requires "
              f"model.norm=batch (got {enc_norm!r}); skipping")
        return None
    loaded = load_shapenet_encoder(model, pth)
    print(f"Encoder warm-started from {pth} ({len(loaded)} tensors)")
    return loaded


def evaluate(model, loader, handler, weights, device):
    """Mean eval loss and per-term losses over the loader."""
    tot, count, terms_sum = 0.0, 0, {}
    for batch in loader.epoch(0):
        b = batch_to_device(batch, device)
        loss, terms, _ = eval_step(model, handler, b, weights)
        n = batch["point_cloud"].shape[0]
        tot += float(loss) * n
        for k, v in terms.items():
            terms_sum[k] = terms_sum.get(k, 0.0) + float(v) * n
        count += n
    return tot / count, {k: v / count for k, v in terms_sum.items()}


def main(argv=None):
    """Train; returns (run_dir, model)."""
    config = load_args(argv=argv)
    device = resolve_device(config.get("device") or "cuda")
    _refuse_unported(config)

    run_dir = create_dirs(os.path.join(get_output_dir(config),
                                       get_run_name(config)))
    save_config(config, run_dir)
    print(f"Run dir: {run_dir}")
    seed = set_seed(config.get("seed"))
    generator = torch.Generator(device=device).manual_seed(seed)

    # ---- data -------------------------------------------------------------
    tr_dataset = PaintDataset(config, split="train",
                              size=config.get("dataset_size"))
    te_dataset = PaintDataset(config, split="test",
                              size=config.get("test_dataset_size"))
    batch_size = int(config["batch_size"])
    tr_loader = DataLoader(tr_dataset, batch_size, shuffle=True,
                           seed=int(config.get("seed") or 0))
    te_loader = DataLoader(te_dataset, min(batch_size, len(te_dataset)),
                           shuffle=False, drop_last=False)
    if len(tr_loader) == 0:
        raise ValueError(
            f"training split ({len(tr_dataset)} samples) is smaller than "
            f"batch_size={batch_size} (drop_last loader yields no batches); "
            f"lower batch_size or raise dataset_size")

    # ---- model, optimizer, loss -------------------------------------------
    model = get_model(config, device=device,
                      generator=torch.Generator().manual_seed(seed))
    if config["model"].get("pretrained"):
        warm_start_encoder(model, config)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model: {config['model']['backbone']} | params: "
          f"{n_params / 1e6:.2f}M | device: {device}")
    optimizer = make_optimizer(model, config)
    lr_sched = make_lr_scheduler(optimizer, config)
    handler = LossHandler(config["loss"], config)
    weights = handler.init_weights()
    psacd = (PSACDScheduler(config["psacd_scheduler"])
             if config["psacd_scheduler"].get("active") else None)
    if config.get("eval_metrics"):
        print(f"NOTE: eval metrics {list(config['eval_metrics'])} are not "
              f"ported yet; only the eval loss is logged")

    epochs = int(config["epochs"])
    eval_freq = int(config["eval_freq"])
    best_eval_loss, best_epoch = float("inf"), -1
    t_train0 = time.time()
    with open(os.path.join(run_dir, "logs.jsonl"), "a") as log_fh:
        for epoch in range(epochs):
            t0 = time.time()
            losses, term_acc = [], []
            for batch in tr_loader.epoch(epoch):
                loss, terms = train_step(model, optimizer, handler,
                                         batch_to_device(batch, device),
                                         weights, generator)
                losses.append(loss)
                term_acc.append(terms)
            # one host sync per epoch
            epoch_loss = float(torch.stack(losses).mean())
            log = {"train_loss": epoch_loss, "epoch": epoch + 1,
                   "epoch_seconds": time.time() - t0}
            for k in term_acc[0]:
                log[f"{k}_train_loss"] = float(
                    torch.stack([t[k] for t in term_acc]).mean())

            if (epoch + 1) % eval_freq == 0 or (epoch + 1) == epochs:
                eval_loss, eval_terms = evaluate(model, te_loader, handler,
                                                 weights, device)
                log["eval_loss"] = eval_loss
                log.update({f"{k}_eval_loss": v
                            for k, v in eval_terms.items()})
                is_best = eval_loss < best_eval_loss
                if is_best:
                    best_eval_loss, best_epoch = eval_loss, epoch + 1
                if not config.get("no_save"):
                    save_checkpoint(run_dir, "last_checkpoint", model,
                                    epoch=epoch + 1)
                    if is_best:
                        copy_checkpoint(run_dir, "last_checkpoint",
                                        "best_model")
                    if (config.get("save_intermediate_models")
                            and (epoch + 1) % int(
                                config["save_intermediate_models_freq"]) == 0):
                        copy_checkpoint(
                            run_dir, "last_checkpoint",
                            f"intermediate_checkpoint_epoch{epoch + 1}")
                print(f"[{epoch + 1}/{epochs}] train {epoch_loss:.4f} "
                      f"| eval {eval_loss:.4f} | {log['epoch_seconds']:.2f}s")
            log_fh.write(json.dumps(log) + "\n")
            log_fh.flush()

            if lr_sched is not None:
                lr_sched.step()
            if psacd is not None and psacd.is_time_to_step(epoch, epochs):
                weights = psacd.step_loss_weights(weights)
            weights = apply_delayed_activations(config, weights, epoch)

    tot = time.time() - t_train0
    summary = {"best_epoch": best_epoch, "best_eval_loss": best_eval_loss,
               "tot_train_seconds": round(tot, 2)}
    with open(os.path.join(run_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh)
    print(f"Training finished in {tot:.1f}s | best epoch {best_epoch} "
          f"({best_eval_loss:.4f})")
    if not config.get("no_save"):
        print("NOTE: the final-eval .npy prediction dumps are not ported "
              "yet (ROADMAP.md, port queue)")
    model.eval()
    return run_dir, model


if __name__ == "__main__":
    main()
