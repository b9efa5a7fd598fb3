"""The port's MaskPlanner training entry point
(``train_maskplanner.py`` of the JAX package).

    python -m maskplanner_tpu_torch.train_maskplanner \\
        config=[maskplanner,windows_v2,longx_v2] seed=1

The same ``config=[...] k=v`` contract: config -> seed -> run dir and frozen
config -> data -> model -> Adam and the LR milestones -> the epoch loop,
with the eval loss and ``eval_metrics`` (``metrics.MetricsHandler``, logged
under the JAX names) every ``eval_freq`` epochs, then the PSACD curriculum
and the delayed loss activations -> the final eval. At every eval it writes
``last_checkpoint`` (``convert.save_checkpoint``: the weights, Adam, the LR
scheduler, the step count and the training generator), copies it to
``best_model`` when the eval loss improves and, under
``save_intermediate_models``, to ``intermediate_checkpoint_epoch{N}`` every
``save_intermediate_models_freq`` epochs; the port's ``Predictor`` serves
any of them. After training the final eval (``train.loop.evaluate``) scores
``eval_ckpt`` (``best_model`` when asked for and present, else
``last_checkpoint``) on the train and test splits, writes the ``.npy``
dumps under ``<run_dir>/results/`` and the ``final_*`` and
``*_inference_ms`` keys of ``summary.json``. ``no_save`` writes no
checkpoint and runs no final eval. The run log is ``utils.logging.Run``:
``logs.jsonl`` a line an epoch (with ``_time`` and ``_step``) and
``summary.json``, mirrored to wandb where it imports, under the JAX
driver's rule for its mode (``wandb_mode``).

``resume=<run_dir>`` (or a run name under ``output_dir``) continues that
run: the frozen config wins but for the keys typed on this command line,
and model, Adam, the LR scheduler, the step count and the generator come
from its ``last_checkpoint``, so that on the CPU the resumed run ends
bitwise equal to an uninterrupted one. A bare ``resume=true`` starts a
fresh run. SIGTERM or SIGINT ends the run at the end of the current epoch,
with ``last_checkpoint`` saved (unless ``no_save``).

``device_dataset=auto`` (the default, as in the JAX driver) or ``true``
stages the training split on the device (``data.device_dataset``) when the
config is eligible and the split fits, and runs every epoch over it
(``train.trainer.DeviceEpoch``): on the card each step is one replay of a
CUDA graph of the whole step, on the CPU the same step runs eagerly, and
the host syncs once an epoch. Otherwise (``device_dataset=false``, an
ineligible config, a split over the limit) the host loader's batches come
through a ``data.prefetch.Prefetcher``. On the CPU the two give bitwise the
same run. The PSACD curriculum and the delayed activations update a dict
of float loss weights, which the driver then loads in place into the 0-d
tensors on the device that the step reads (``losses.DeviceWeights``).

It runs on the card unless ``device=cpu`` is given; ``device=cuda`` without
a card raises. With ``model.pretrained`` (the default) and
``model.norm=batch`` it warm-starts the encoder from the original
repository's ShapeNet checkpoint when the file is there. Under
``model.bf16=true`` the model trains in bf16 (the JAX package's dtype
rules; ``models.pointnet2``) on f32 parameters: the frozen config keeps the
flag, the checkpoints hold the f32 parameters, and a ``Predictor`` of the
run serves it in bf16. Under ``profile=true`` it records the second
epoch's training steps with ``torch.profiler`` (``utils/profiling.py``:
the host, and the card's kernels on the card) into
``<run_dir>/profile/trace.json``, as the JAX package's entry point traces
that epoch; a run with fewer than 2 epochs left has no second epoch and
raises.

``model.pretrained_custom=<run_dir>`` warm-starts the model from another
run, in the JAX driver's order: a port run's ``last_checkpoint.torch.pt``
(weights and BatchNorm statistics; ``fc3`` and ``fc_normals`` keep their
fresh init unless ``model.load_strict``), else a reference run's
``last_checkpoint.pth`` (the same rule), else a JAX run's orbax
``last_checkpoint/`` raises, naming ``tools/orbax_to_torch.py``, which
writes the run's ``last_checkpoint.torch.pt``; else it warns and trains
from scratch. It loads in place before Adam and the device
epoch are built, and takes the place of the ShapeNet warm start.

Every loss name of the JAX registry whose inputs the training step gives
trains (with the paper's baselines ``segmentWise`` and ``pointWise``), on
the backbones of ``TRAINABLE_BACKBONES``: ``pointnet2_strokemasks``,
``pointnet2`` (the plain regressor, whose eval has no masks), and the
backbones that the JAX driver trains on its point clouds as it trains the
regressor: ``pointnet`` and ``pointnet_deeper`` (without orientations, as
the JAX factory asserts), ``pointnet_segmenter``,
``pointnet_segmenter_conv1d`` and the two PointNet++ segmenters (with
``latent_dim``, which has no default). The start-of-path, stroke-wise,
rollout and transformer backbones, the random-noise generator and the
critic build (``models.get_model``) but do not train here, as the JAX
driver does not train them: the driver refuses them.

A ``loss`` with an adversarial term (``discriminator``, ``wdiscriminator``;
``losses.gan``) trains on the host loader (``device_dataset_eligible``
refuses it, as the JAX driver's does) with ``train.trainer.gan_train_step``:
each step also updates the critic, whose loss is logged as
``d_internal_train_loss``. Its state (``losses.gan.CriticState``) is saved
beside every ``last_checkpoint`` (``last_checkpoint_aux.torch.pt``) and
copied beside ``best_model``; ``resume=`` restores it, and a run without
that file starts a fresh critic, as the JAX driver does. On the card a loss term that a CUDA
graph cannot capture (``LossHandler.uncapturable``: the singular values
of ``align``, ``intra_align``) trains on the host loader, and the run
prints why. After the final eval, unless ``skip_rendering`` or ``debug``,
a child process renders the dumps (``render_results``, PNGs under
``<run_dir>/renders/``), as the JAX driver does; its exit status is
printed and a failed render never fails the run (rendering needs
matplotlib, which only that child imports).

Data-parallel training, one process a card (the JAX driver's mesh over
every device):

    torchrun --nproc_per_node=4 -m maskplanner_tpu_torch.train_maskplanner \\
        config=[maskplanner,windows_v2,longx_v2] seed=1

``batch_size`` is the global batch; each rank (``cuda:LOCAL_RANK``) trains
on ``batch_size / N`` rows of it, and a ``batch_size`` that N does not
divide raises. The step is the single-process step at the global batch
(``train.trainer``, ``parallel``): every rank holds the same parameters,
Adam state and generator. The device-resident epoch stages the whole split
on every rank, which gathers its rows of each batch; the host loader gives
each rank its rows (``DataLoader(num_shards=N, shard_index=rank)``, whose
augmentations draw per shard, as the JAX multi-host loader's do). Only
rank 0 writes (the run directory, the config, ``logs.jsonl``, checkpoints,
the final eval's dumps and its render child, the ``profile=true`` trace).
Every rank evaluates, at every eval and at the final eval, as the JAX
driver does under its mesh: each batch that divides over the ranks is
sharded, and the results are the single process's
(``train.loop.evaluate``); the final eval's weights are rank 0's
checkpoint, sent to every rank. ``resume``
loads the same checkpoint on every rank; SIGTERM or SIGINT on any rank
stops every rank at the end of the same epoch (``parallel.agree``). A
recipe with an adversarial term trains on the sharded host loader, its
critic replicated on every rank and updated as the single process's at the
global batch (``train.trainer.gan_train_step``); rank 0 alone writes the
critic's state, and every rank loads it on resume. Without torchrun's
``WORLD_SIZE`` (or with 1) nothing of this applies. A process already
in a group (``parallel.distributed_init``) runs in that group.
"""
from __future__ import annotations

import itertools
import os
import signal
import subprocess
import sys
import time

import torch

from .convert import (aux_name, checkpoint_path, copy_checkpoint,
                      load_aux_state, load_checkpoint, load_params_only,
                      load_shapenet_encoder, load_torch_pretrained,
                      load_training_state, save_aux_state, save_checkpoint)
from .data.dataset import DataLoader, PaintDataset
from .data.device_dataset import (device_dataset_eligible, epoch_perm,
                                  stage_device_dataset, staged_bytes)
from .data.prefetch import Prefetcher
from .losses import DeviceWeights, LossHandler
from .losses.gan import AdversarialLoss
from .metrics import MetricsHandler
from .models import STROKE_MASK_BACKBONES, get_model
from .parallel import (agree, distributed_init, from_rank_0, grouped,
                       rank_and_world, replicate)
from .serve import resolve_device
from .train import (PSACDScheduler, apply_delayed_activations, forward,
                    make_lr_scheduler, make_optimizer, train_step)
from .train.loop import evaluate
from .train.trainer import DeviceEpoch, gan_train_step, host_epoch
from .utils import create_dirs, get_run_name, set_seed
from .utils.args import load_args
from .utils.config import load_config, save_config
from .utils.logging import Run
from .utils.profiling import profile_trace

# the directory that holds the package (the render child imports it)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def get_output_dir(config):
    """Priority: config.output_dir > $WORKDIR > ./runs."""
    return config.get("output_dir") or os.environ.get("WORKDIR") or "runs"


def restore_frozen_config(config, run_dir, write: bool = True):
    """Resume-time config restore: the run's frozen ``config.yaml`` wins,
    except for the keys typed on this command line (the merged config also
    holds ``default.yaml``'s underlay, which must not shadow the frozen
    values). The carried keys are saved back (unless not ``write``) so that
    the run's record stays true for the eval and serving entry points."""
    frozen = load_config(os.path.join(run_dir, "config.yaml"))
    carried = [k for k in getattr(config, "cli_overrides", [])
               if k not in ("resume", "default")]
    for key in carried:
        frozen.set_dotted(key, config.select(key))
    if carried and write:
        save_config(frozen, run_dir)
    frozen["resume"] = True
    return frozen


def _resume_dir(config) -> str | None:
    """``resume=<run_dir>`` or a run name under the output dir -> that
    directory; a missing one raises. A bare ``resume=true`` (or no resume)
    -> None: a fresh run."""
    arg = config.get("resume")
    if not isinstance(arg, str) or arg.lower() in ("true", "false", "1",
                                                   "0"):
        return None
    for cand in (arg, os.path.join(get_output_dir(config), arg)):
        if os.path.isdir(cand):
            return cand
    raise ValueError(f"resume={arg!r}: no such run directory")


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


def warm_start_custom(model, config) -> list[str] | None:
    """The transfer-learning warm start (``model.pretrained_custom``, the
    JAX driver's order) -> the loaded keys, or None (nothing to load: it
    warns). A port run's checkpoint (a JAX run's after
    ``tools/orbax_to_torch.py``), else a reference run's ``.pth``; a JAX
    run's orbax checkpoint alone raises, naming that tool."""
    run = config["model"]["pretrained_custom"]
    strict = bool(config["model"].get("load_strict"))
    if os.path.isfile(checkpoint_path(run, "last_checkpoint")):
        loaded = load_params_only(run, "last_checkpoint", model,
                                  filter_heads=not strict)
        print(f"Initialized from pretrained run {run} ({len(loaded)} "
              f"tensors)")
        return loaded
    pth = os.path.join(run, "last_checkpoint.pth")
    if os.path.isfile(pth):
        loaded = load_torch_pretrained(model, pth, mode="full",
                                       load_strict=strict)
        print(f"Initialized from reference torch run {run} ({len(loaded)} "
              f"tensors)")
        return loaded
    if os.path.isdir(os.path.join(run, "last_checkpoint")):
        raise FileNotFoundError(
            f"pretrained_custom {run} is a JAX run (an orbax last_checkpoint/)"
            f" without last_checkpoint.torch.pt: convert it first with "
            f"`python tools/orbax_to_torch.py --run {run}`")
    print(f"WARNING: pretrained_custom {run} has no last_checkpoint; "
          f"training from scratch")
    return None


class _Preemption:
    """SIGTERM and SIGINT set ``flag`` while the block runs; the previous
    handlers come back when it ends."""

    def __init__(self):
        self.flag = False
        self._previous = {}

    def _on_signal(self, signum, frame):
        self.flag = True

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous[sig] = signal.signal(sig, self._on_signal)
            except ValueError:      # not the main thread: no handler
                pass
        return self

    def __exit__(self, *exc):
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)


def wandb_mode(config) -> str:
    """The run log's wandb mode, the JAX driver's rule: ``disabled`` under
    ``debug`` or ``wandb: disabled``, else the config's ``wandb`` key."""
    if config.get("debug") or config.get("wandb") == "disabled":
        return "disabled"
    return config.get("wandb", "disabled")


def _final_eval(config, run_dir, model, loaders, handler, weights,
                metrics_handler, device) -> dict:
    """Score ``eval_ckpt`` on each split with the ``.npy`` dumps under
    ``<run_dir>/results/`` -> the summary's ``final_*`` and
    ``*_inference_ms`` keys. In a process group every rank evaluates
    rank 0's checkpoint, and rank 0 alone writes and renders."""
    rank, _ = rank_and_world()
    eval_ckpt = config.get("eval_ckpt", "last")
    results_dir = None
    if rank == 0:
        name = ("best_model" if eval_ckpt == "best" and os.path.isfile(
            checkpoint_path(run_dir, "best_model")) else "last_checkpoint")
        if os.path.isfile(checkpoint_path(run_dir, name)):
            load_checkpoint(run_dir, name, model)
        results_dir = create_dirs(os.path.join(run_dir, "results"))
    replicate(model)
    summary = {}
    for split, loader in loaders:
        loss, _, metrics, ms = evaluate(
            model, loader, handler, weights, metrics_handler, device,
            save=True, save_dir=results_dir, split=split,
            eval_ckpt=eval_ckpt, forward=forward)
        summary[f"final_{split}_loss"] = loss
        for k, v in metrics.items():
            summary[f"final_{split}_{k}"] = v
        if ms is not None:
            summary[f"{split}_inference_ms"] = ms
    if rank == 0 and not config.get("skip_rendering") \
            and not config.get("debug"):
        render(run_dir, results_dir, eval_ckpt)
    return summary


def render(run_dir: str, results_dir: str, eval_ckpt) -> None:
    """Render the final eval's dumps, as the JAX driver does: a child
    process runs ``render_results`` on 4 samples; its exit status is
    printed, and a failure (or a timeout) never fails the run."""
    print(f"Rendering results from {results_dir} ...")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    try:
        done = subprocess.run(
            [sys.executable, "-m", "maskplanner_tpu_torch.render_results",
             "--run", os.path.abspath(run_dir), "--max_samples", "4",
             "--model", str(eval_ckpt)],
            check=False, timeout=600, env=env)
        print(f"rendering exited with status {done.returncode}")
    except Exception as e:  # rendering must never fail the run
        print(f"(rendering skipped: {e})")


# the backbones whose outputs the training step turns into a loss batch:
# those the JAX driver trains (a 2-epoch run of each on the CPU; it fails
# on mlp_generator, which reshapes a point cloud as noise, and on dgcnn,
# whose logits the chamfer cannot take)
TRAINABLE_BACKBONES = (*STROKE_MASK_BACKBONES, "pointnet2", "pointnet",
                       "pointnet_deeper", "pointnet_segmenter",
                       "pointnet_segmenter_conv1d", "pointnet2_segmenter_v1",
                       "pointnet2_segmenter_paintnet_v1")
ADVERSARIAL_TERMS = ("discriminator", "wdiscriminator")


def main(argv=None):
    """Train; returns (run_dir, model). SIGTERM and SIGINT stop the run at
    the end of the current epoch; the previous handlers come back when it
    returns. Under torchrun (``WORLD_SIZE`` > 1) each process joins the
    group and leaves it when it returns."""
    config = load_args(argv=argv)
    owns_group = not grouped()
    try:
        with _Preemption() as preempted:
            return _train(config, preempted)
    finally:
        if owns_group and grouped():
            torch.distributed.destroy_process_group()


def _train(config, preempted: _Preemption):
    run_dir = _resume_dir(config)
    typed = config
    if run_dir is not None:
        # the frozen config names the device
        config = restore_frozen_config(typed, run_dir, write=False)
    device = resolve_device(config.get("device") or "cuda")
    distributed_init(device=device)
    rank, world = rank_and_world()
    if run_dir is not None:
        agree(False)        # a barrier: every rank has read the file
        if rank == 0:
            # the carried keys written back
            restore_frozen_config(typed, run_dir)
    if device.type == "cuda" and grouped():
        device = torch.device("cuda", torch.cuda.current_device())
    if int(config["batch_size"]) % world:
        raise ValueError(f"batch_size={config['batch_size']} (the global "
                         f"batch) does not divide over {world} ranks")
    if config["model"]["backbone"] not in TRAINABLE_BACKBONES:
        raise NotImplementedError(
            f"the driver trains {', '.join(TRAINABLE_BACKBONES)}; "
            f"{config['model']['backbone']!r} has no loss batch in the "
            f"training step (the JAX driver does not train it either): build "
            f"its batches and call losses.LossHandler directly")
    if run_dir is None and rank == 0:
        run_dir = create_dirs(os.path.join(get_output_dir(config),
                                           get_run_name(config)))
        save_config(config, run_dir)
    if rank == 0:
        print(f"Run dir: {run_dir}")
    # after the frozen config's restore: a resumed run keeps its own seed;
    # rank 0's on every rank (seed 0 or none draws a fresh one), so that
    # every rank's generator makes the same draws over the global batch
    seed = set_seed(from_rank_0(set_seed(config.get("seed"))))
    generator = torch.Generator(device=device).manual_seed(seed)

    # ---- data -------------------------------------------------------------
    tr_dataset = PaintDataset(config, split="train",
                              size=config.get("dataset_size"))
    te_dataset = PaintDataset(config, split="test",
                              size=config.get("test_dataset_size"))
    batch_size = int(config["batch_size"])
    # each rank's rows of every global batch
    tr_loader = DataLoader(tr_dataset, batch_size, shuffle=True,
                           seed=int(config.get("seed") or 0),
                           num_shards=world, shard_index=rank)
    # the evals take the global batches, which they shard themselves
    te_loader = DataLoader(te_dataset, min(batch_size, len(te_dataset)),
                           shuffle=False, drop_last=False)
    if len(tr_loader) == 0:
        raise ValueError(
            f"training split ({len(tr_dataset)} samples) is smaller than "
            f"batch_size={batch_size} (drop_last loader yields no batches); "
            f"lower batch_size or raise dataset_size")

    # ---- model, optimizer, loss, metrics ----------------------------------
    model = get_model(config, device=device,
                      generator=torch.Generator().manual_seed(seed))
    # in place, before Adam and the device epoch hold the parameters
    if config["model"].get("pretrained_custom"):
        warm_start_custom(model, config)
    elif config["model"].get("pretrained"):
        warm_start_encoder(model, config)
    replicate(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model: {config['model']['backbone']} | params: "
          f"{n_params / 1e6:.2f}M | device: {device}")
    optimizer = make_optimizer(model, config)
    lr_sched = make_lr_scheduler(optimizer, config)
    handler = LossHandler(config["loss"], config)
    floats = handler.init_weights()
    weights = DeviceWeights(floats, device)
    metrics_handler = MetricsHandler(config, config.get("eval_metrics") or [])
    psacd = (PSACDScheduler(config["psacd_scheduler"])
             if config["psacd_scheduler"].get("active") else None)

    # an adversarial term: the critic beside the model, its own step
    critic = None
    gan_kinds = [n for n in config["loss"] if n in ADVERSARIAL_TERMS]
    if gan_kinds:
        adv = AdversarialLoss(config, kind=gan_kinds[0])
        critic = adv.init_state(
            tr_dataset[0]["traj"][None], device,
            torch.Generator().manual_seed(seed + 17))

    epochs = int(config["epochs"])
    start_epoch, step = 0, 0
    # every rank loads the same checkpoint (a fresh run's rank > 0 has no
    # run directory)
    if config.get("resume") and run_dir is not None and os.path.isfile(
            checkpoint_path(run_dir, "last_checkpoint")):
        start_epoch, step = load_training_state(
            run_dir, "last_checkpoint", model, optimizer, lr_sched, generator)
        if critic is not None and not load_aux_state(
                run_dir, "last_checkpoint", critic):
            print("WARNING: no critic state beside last_checkpoint; the "
                  "critic starts fresh")
        # PSACD steps are cumulative and the delayed activations gated by
        # epoch: replay every epoch already done
        for e in range(start_epoch):
            if psacd is not None and psacd.is_time_to_step(e, epochs):
                floats = psacd.step_loss_weights(floats)
            floats = apply_delayed_activations(config, floats, e)
        weights.load(floats)
        print(f"Resumed from epoch {start_epoch} (step {step})")
    step_fn = train_step
    if critic is not None:
        # the step count before each step gates the critic's update
        counter = itertools.count(step)

        def gan_step(*args):
            return gan_train_step(*args, adv=adv, critic=critic,
                                  step=next(counter))
        step_fn = gan_step
    if config.get("profile") and epochs - start_epoch < 2:
        raise ValueError(f"profile=true traces the second epoch, but "
                         f"epochs={epochs} with {start_epoch} done")

    # the device-resident epoch where it applies, else the host loader
    device_epoch = data = None
    # on the card the device-resident epoch is a CUDA graph of the step
    uncapturable = handler.uncapturable if device.type == "cuda" else {}
    if uncapturable:
        print(f"device-resident dataset: off, the step cannot be captured "
              f"as a CUDA graph: {uncapturable}")
    elif device_dataset_eligible(config, world, batch_size):
        data = stage_device_dataset(tr_dataset, device=device)
    if data is not None:
        device_epoch = DeviceEpoch(model, optimizer, handler, data, weights,
                                   generator, int(config["pc_points"]),
                                   step_fn=train_step)
        print(f"device-resident dataset: epoch-as-one-dispatch enabled "
              f"(staged split {staged_bytes(data) / 2**20:.1f} MiB"
              + (", the step as a CUDA graph)" if device_epoch.graphed
                 else ")"))
    else:
        prefetcher = Prefetcher(tr_loader, device)

    def save(name: str, epoch: int) -> None:
        if rank:
            return
        save_checkpoint(run_dir, name, model, epoch, optimizer=optimizer,
                        lr_sched=lr_sched, step=step, generator=generator)
        if critic is not None:
            save_aux_state(run_dir, name, critic)

    def copy(src: str, dst: str) -> None:
        if rank:
            return
        copy_checkpoint(run_dir, src, dst)
        if critic is not None:
            copy_checkpoint(run_dir, aux_name(src), aux_name(dst))

    eval_freq = int(config["eval_freq"])
    best_eval_loss, best_epoch = float("inf"), -1
    eval_loss = float("nan")
    t_train0 = time.time()
    # rank 0 logs; the other ranks write nothing
    run = (Run(run_dir, config=config.to_dict(),
               group=config.get("group") or config.get("auto_wandb_group"),
               name=config.get("name"), mode=wandb_mode(config))
           if rank == 0 else None)
    try:
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            with profile_trace(run_dir, bool(config.get("profile"))
                               and epoch == start_epoch + 1 and rank == 0,
                               device):
                if device_epoch is not None:
                    losses, terms = device_epoch.run(epoch_perm(
                        len(tr_dataset), batch_size,
                        int(config.get("seed") or 0), epoch))
                else:
                    losses, terms = host_epoch(
                        model, optimizer, handler, prefetcher.epoch(epoch),
                        weights, generator, step_fn=step_fn)
            step += len(losses)
            # one host sync per epoch
            epoch_loss = float(losses.mean())
            log = {"train_loss": epoch_loss, "epoch": epoch + 1,
                   "epoch_seconds": time.time() - t0}
            for k, v in terms.items():
                log[f"{k}_train_loss"] = float(v.mean())
            # the schedule of the next epoch, before a checkpoint holds it
            if lr_sched is not None:
                lr_sched.step()

            # every rank evaluates its rows of the test split; rank 0 logs
            # and writes
            if (epoch + 1) % eval_freq == 0 or (epoch + 1) == epochs:
                eval_loss, eval_terms, eval_metrics, _ = evaluate(
                    model, te_loader, handler, weights, metrics_handler,
                    device)
                log["eval_loss"] = eval_loss
                log.update({f"{k}_eval_loss": v
                            for k, v in eval_terms.items()})
                log.update(eval_metrics)
                is_best = eval_loss < best_eval_loss
                if is_best:
                    best_eval_loss, best_epoch = eval_loss, epoch + 1
                if not config.get("no_save"):
                    save("last_checkpoint", epoch + 1)
                    if is_best:
                        copy("last_checkpoint", "best_model")
                    if (config.get("save_intermediate_models")
                            and (epoch + 1) % int(
                                config["save_intermediate_models_freq"]) == 0):
                        copy("last_checkpoint",
                             f"intermediate_checkpoint_epoch{epoch + 1}")
                if rank == 0:
                    print(f"[{epoch + 1}/{epochs}] train {epoch_loss:.4f} "
                          f"| eval {eval_loss:.4f} | "
                          f"{log['epoch_seconds']:.2f}s")
            if run is not None:
                run.log(log, step=epoch + 1)

            if psacd is not None and psacd.is_time_to_step(epoch, epochs):
                floats = psacd.step_loss_weights(floats)
            floats = apply_delayed_activations(config, floats, epoch)
            weights.load(floats)

            # a signal on any rank stops every rank after this epoch
            if agree(preempted.flag):
                if not config.get("no_save"):
                    save("last_checkpoint", epoch + 1)
                    if rank == 0:
                        print(f"Preempted at epoch {epoch + 1}; checkpoint "
                              f"saved (resume with resume={run_dir})")
                break
    finally:
        if device_epoch is not None:
            # before the group goes (DeviceEpoch.close)
            device_epoch.close()

    tot = time.time() - t_train0
    summary = {"best_epoch": best_epoch, "best_eval_loss": best_eval_loss,
               "last_eval_loss": eval_loss,
               "tot_train_seconds": round(tot, 2)}
    if rank == 0:
        print(f"Training finished in {tot:.1f}s | best epoch {best_epoch} "
              f"({best_eval_loss:.4f})")
    if not config.get("no_save"):
        # the train split's global batches, in the single process's order
        loaders = (("train", DataLoader(
            tr_dataset, batch_size, shuffle=True,
            seed=int(config.get("seed") or 0))), ("test", te_loader))
        summary.update(_final_eval(config, run_dir, model, loaders, handler,
                                   weights, metrics_handler, device))
    if run is not None:
        run.summary.update(summary)
        run.finish()
    model.eval()
    return run_dir, model


if __name__ == "__main__":
    main()
