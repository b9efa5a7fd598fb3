"""The port's default training loop on the CPU: the device-resident epoch
(``data/device_dataset.py``, ``train.trainer.DeviceEpoch``), the host
``Prefetcher`` and the loss weights as tensors, against the JAX package
where it has a counterpart and against the port's host-loader path
elsewhere.

On the CPU the device-resident epoch runs its step eagerly, so it must be
bitwise the host-loader epoch: the same batches (``epoch_perm`` is the
loader's order), the same step, the same generator. The CUDA-graphed form
runs on the card only (``chip_smoke.py``).
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
SMALL = [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]",
         "n_pred_traj_points=120", "max_n_strokes=6"]
# the JAX e2e tests' tiny configuration (tests/test_train_e2e.py)
TINY = ["config=[maskplanner,cuboids_v2,longx_v2,debug]", "pc_points=64",
        "n_pred_traj_points=80", "batch_size=2", "epochs=4", "eval_freq=2",
        "dataset_size=2", "test_dataset_size=2", "no_save=false", "seed=1"]
# a 3-epoch run whose resumed part crosses an LR milestone, a PSACD step
# and the stroke-mask loss's delayed activation
RUN = [*SMALL, "device=cpu", "batch_size=2", "dataset_size=4",
       "test_dataset_size=2", "epochs=3", "eval_freq=1", "no_save=false",
       "seed=3", "lr_sched.step_sizes=[1,2]",
       "psacd_scheduler.milestones=[1,2]", "start_stroke_masks_loss_at=2"]
STEPS_PER_EPOCH = 2


class _Indices:
    """A dataset of ``n`` items, each its own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("n,batch,seed,epoch,shuffle", [
    (11, 2, 0, 0, True), (11, 3, 5, 2, True), (8, 4, 1, 7, True),
    (11, 11, 3, 1, True), (11, 4, 0, 0, False), (9, 2, 2, 3, False)])
def test_epoch_perm_is_the_jax_one_and_the_loaders_order(n, batch, seed,
                                                         epoch, shuffle):
    from maskplanner_tpu.data.device_dataset import epoch_perm as jax_perm
    from maskplanner_tpu_torch.data import DataLoader
    from maskplanner_tpu_torch.data.device_dataset import epoch_perm

    got = epoch_perm(n, batch, seed, epoch, shuffle)
    np.testing.assert_array_equal(got, jax_perm(n, batch, seed, epoch,
                                                shuffle))
    assert got.dtype == np.int32
    loader = DataLoader(_Indices(n), batch, shuffle=shuffle, seed=seed)
    order = np.stack([b["i"] for b in loader.epoch(epoch)])
    np.testing.assert_array_equal(got, order)


ELIGIBILITY = {
    "default": ({}, 1, None),
    "mesh of 8, batch 16": ({}, 8, 16),
    "mesh of 8, batch 6": ({}, 8, 6),
    "mesh of 8, batch unknown": ({}, 8, None),
    "online subsampling": (
        {"augmentations": "[pc_online_subsampling]"}, 1, None),
    "online subsampling and noise": (
        {"augmentations": "[pc_online_subsampling,general_noise]"}, 1, None),
    "adversarial loss": ({"loss": "[chamfer,wdiscriminator]"}, 1, None),
    "device_dataset=false": ({"device_dataset": "false"}, 1, None),
    "device_dataset=true": ({"device_dataset": "true"}, 1, None),
}


@pytest.mark.parametrize("case", list(ELIGIBILITY))
def test_eligibility_is_the_jax_packages(case):
    from maskplanner_tpu.data.device_dataset import \
        device_dataset_eligible as jax_eligible
    from maskplanner_tpu_torch.data.device_dataset import \
        device_dataset_eligible

    over, n_devices, batch = ELIGIBILITY[case]
    argv = [*TINY, *(f"{k}={v}" for k, v in over.items())]
    want = jax_eligible(jax_load_args(argv=argv), n_devices, batch)
    assert device_dataset_eligible(load_args(argv=argv), n_devices,
                                   batch) == want


@pytest.mark.parametrize("online", [False, True],
                         ids=["subsampled", "full-resolution"])
def test_staged_split_is_the_jax_one(online):
    from maskplanner_tpu.data.dataset import PaintDataset as JaxDataset
    from maskplanner_tpu.data.device_dataset import \
        stage_device_dataset as jax_stage
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.data.device_dataset import (
        stage_device_dataset, staged_bytes)

    argv = [*TINY, "dataset_size=4"]
    if online:
        argv.append("augmentations=[pc_online_subsampling]")
    ref = jax_stage(JaxDataset(jax_load_args(argv=argv), "train", size=4))
    ds = PaintDataset(load_args(argv=argv), "train", size=4)
    got = stage_device_dataset(ds, device="cpu")
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert got["point_cloud"].shape[1] == (2 if online else 1) * 64
    # the limit is on the stacked split's bytes
    size = staged_bytes(got)
    assert stage_device_dataset(ds, byte_limit=size, device="cpu") is not None
    assert stage_device_dataset(ds, byte_limit=size - 1, device="cpu") is None


def _setup(argv, items=4):
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.losses import DeviceWeights, LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import (apply_delayed_activations,
                                             make_optimizer)

    cfg = load_args(argv=argv)
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    handler = LossHandler(cfg["loss"], cfg)
    weights = DeviceWeights(apply_delayed_activations(
        cfg, handler.init_weights(), 10 ** 6), "cpu")
    return dict(cfg=cfg, model=model, handler=handler, weights=weights,
                optimizer=make_optimizer(model, cfg),
                generator=torch.Generator().manual_seed(7),
                dataset=PaintDataset(cfg, "train", size=items))


@pytest.mark.parametrize("norm", ["layer+layer+batch", "batch"])
def test_device_epoch_is_bitwise_the_host_epoch(norm):
    from maskplanner_tpu_torch.data import DataLoader
    from maskplanner_tpu_torch.data.device_dataset import (
        epoch_perm, stage_device_dataset)
    from maskplanner_tpu_torch.data.prefetch import Prefetcher
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch, host_epoch

    argv = [*SMALL, f"model.norm={norm}"]
    host, dev = _setup(argv), _setup(argv)
    fetch = Prefetcher(DataLoader(host["dataset"], 2, shuffle=True, seed=1),
                       "cpu")
    data = stage_device_dataset(dev["dataset"], device="cpu")
    epoch = DeviceEpoch(dev["model"], dev["optimizer"], dev["handler"], data,
                        dev["weights"], dev["generator"], 64)
    assert not epoch.graphed
    for e in range(2):
        want = host_epoch(host["model"], host["optimizer"], host["handler"],
                          fetch.epoch(e), host["weights"], host["generator"])
        got = epoch.run(epoch_perm(4, 2, 1, e))
        assert torch.equal(got[0], want[0]) and got[0].shape == (2,)
        assert got[1].keys() == want[1].keys()
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), k
    # parameters and BatchNorm statistics, Adam, the generator
    for (k, a), b in zip(host["model"].state_dict().items(),
                         dev["model"].state_dict().values()):
        assert torch.equal(a, b), k
    assert any("running_mean" in k for k in host["model"].state_dict())
    for a, b in zip(host["optimizer"].state.values(),
                    dev["optimizer"].state.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(host["generator"].get_state(),
                       dev["generator"].get_state())


def test_graphed_epoch_needs_a_card():
    from maskplanner_tpu_torch.data.device_dataset import stage_device_dataset
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch

    s = _setup(SMALL, items=2)
    data = stage_device_dataset(s["dataset"], device="cpu")
    with pytest.raises(ValueError, match="card"):
        DeviceEpoch(s["model"], s["optimizer"], s["handler"], data,
                    s["weights"], s["generator"], 64, graphed=True)


def test_tensor_weights_give_the_float_weights_losses_bitwise():
    """Over the epochs of ``test_lr_psacd_and_delayed_activations_match_
    over_epochs`` (two PSACD steps, the stroke-mask loss's activation), the
    weights updated in place give bitwise the loss and the gradients of
    the float weights."""
    from maskplanner_tpu_torch.data import collate
    from maskplanner_tpu_torch.losses import DeviceWeights, LossHandler
    from maskplanner_tpu_torch.train import (PSACDScheduler,
                                             apply_delayed_activations,
                                             batch_to_device,
                                             build_loss_batch, forward)

    s = _setup([*SMALL, "epochs=40", "psacd_scheduler.milestones=[7,20]",
                "start_stroke_masks_loss_at=9"], items=2)
    cfg = s["cfg"]
    handler = LossHandler(cfg["loss"], cfg)
    floats = handler.init_weights()
    tensors = DeviceWeights(floats, "cpu")
    held = {k: id(v) for k, v in tensors.items()}
    batch = batch_to_device(collate([s["dataset"][i] for i in range(2)]),
                            "cpu")
    out = forward(s["model"], batch["point_cloud"])
    lb = build_loss_batch(out, batch)
    lb["y_pred"] = lb["y_pred"].detach().requires_grad_(True)

    def loss(weights):
        total, terms = handler.compute(weights, **lb)
        return total, terms, torch.autograd.grad(total, lb["y_pred"])[0]

    psacd = PSACDScheduler(cfg["psacd_scheduler"])
    changed = 0
    for epoch in range(40):
        if psacd.is_time_to_step(epoch, 40):
            floats = psacd.step_loss_weights(floats)
        floats = apply_delayed_activations(cfg, floats, epoch)
        tensors.load(floats)
        assert {k: id(v) for k, v in tensors.items()} == held
        for k, v in floats.items():
            assert tensors[k].item() == float(np.float32(v)), k
        if epoch in (0, 6, 8, 19, 39):
            (a, ta, ga), (b, tb, gb) = loss(floats), loss(tensors)
            assert torch.equal(a, b) and torch.equal(ga, gb), epoch
            assert all(torch.equal(ta[k], tb[k]) for k in ta)
            changed += 1
    assert floats["explicit_weight_stroke_masks_confidence"] == 100.0
    assert floats["weight_symm_point_chamfer"] != \
        cfg["weight_symm_point_chamfer"]
    assert changed == 5


def test_on_device_subsample_draw():
    """A fresh without-replacement subset per sample per step, in range,
    deterministic under the generator's seed."""
    from maskplanner_tpu_torch.train.trainer import subsample_points

    B, N, n = 3, 128, 64
    pc = (torch.arange(N, dtype=torch.float32)[None, :, None]
          + 1000.0 * torch.arange(B, dtype=torch.float32)[:, None, None]
          ).expand(B, N, 3).contiguous()

    def draws(seed, steps=2):
        g = torch.Generator().manual_seed(seed)
        return [(subsample_points(pc, n, g)[..., 0]
                 - 1000.0 * torch.arange(B)[:, None]).long()
                for _ in range(steps)]

    s0, s1 = draws(0)
    for s in (s0, s1):
        assert s.shape == (B, n)
        assert int(s.min()) >= 0 and int(s.max()) < N
        assert all(len(set(row.tolist())) == n for row in s)
    assert not torch.equal(s0, s1)            # varies by step
    assert not torch.equal(s0[0], s0[1])      # and by sample
    assert torch.equal(draws(0)[0], s0)       # deterministic
    assert not torch.equal(draws(1)[0], s0)


def test_device_epoch_with_online_subsampling():
    from maskplanner_tpu_torch.data.device_dataset import (
        device_dataset_eligible, epoch_perm, stage_device_dataset)
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch

    argv = [*SMALL, "augmentations=[pc_online_subsampling]"]
    runs = []
    for _ in range(2):
        s = _setup(argv)
        assert device_dataset_eligible(s["cfg"], 1, 2)
        data = stage_device_dataset(s["dataset"], device="cpu")
        assert data["point_cloud"].shape[1] == 128
        epoch = DeviceEpoch(s["model"], s["optimizer"], s["handler"], data,
                            s["weights"], s["generator"], 64)
        runs.append([epoch.run(epoch_perm(4, 2, 1, e))[0] for e in range(2)])
    for a, b in zip(*runs):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())


class _Raises:
    def __init__(self, loader):
        self.loader = loader

    def epoch(self, epoch):
        yield next(self.loader.epoch(epoch))
        raise ValueError("the producer failed")


def test_prefetcher_yields_the_loaders_batches_and_its_error():
    from maskplanner_tpu_torch.data import DataLoader, PaintDataset
    from maskplanner_tpu_torch.data.prefetch import Prefetcher

    ds = PaintDataset(load_args(argv=TINY), "train", size=4)
    loader = DataLoader(ds, 2, shuffle=True, seed=5)
    direct = list(loader.epoch(1))
    fetched = list(Prefetcher(loader, "cpu").epoch(1))
    assert len(direct) == len(fetched) == 2
    for d, f in zip(direct, fetched):
        assert d.keys() == f.keys()
        for k in d:
            assert isinstance(f[k], torch.Tensor)
            np.testing.assert_array_equal(d[k], f[k].numpy(), err_msg=k)
    batches = Prefetcher(_Raises(loader), "cpu").epoch(0)
    next(batches)
    with pytest.raises(ValueError, match="producer failed"):
        next(batches)
    # a consumer that stops early leaves no producer blocked
    early = Prefetcher(loader, "cpu", depth=1).epoch(0)
    next(early)
    early.close()


def _train_losses(run_dir):
    with open(os.path.join(run_dir, "logs.jsonl")) as fh:
        return [{k: v for k, v in json.loads(line).items()
                 if k.endswith("loss")} for line in fh]


def test_driver_auto_and_false_train_alike(tmp_path, capsys):
    from maskplanner_tpu_torch import train_maskplanner

    args = [*SMALL, "device=cpu", "batch_size=2", "dataset_size=4",
            "test_dataset_size=2", "epochs=2", "seed=1"]
    runs = {}
    for flag in ("auto", "false"):
        runs[flag], _ = train_maskplanner.main(
            [*args, f"device_dataset={flag}", f"output_dir={tmp_path}/{flag}"])
        out = capsys.readouterr().out
        line = "device-resident dataset: epoch-as-one-dispatch enabled"
        assert (line in out) == (flag == "auto")
    assert _train_losses(runs["auto"]) == _train_losses(runs["false"])
    assert len(_train_losses(runs["auto"])) == 2


def _stopped_and_resumed(tmp_path, name, stop_flag, resume_flag):
    """A run on ``device_dataset=stop_flag`` stopped by SIGTERM during
    epoch 2, resumed on ``device_dataset=resume_flag``."""
    from maskplanner_tpu_torch import train_maskplanner

    mp = pytest.MonkeyPatch()
    step, calls = train_maskplanner.train_step, []

    def step_then_sigterm(*args, **kwargs):
        out = step(*args, **kwargs)
        calls.append(1)
        if len(calls) == STEPS_PER_EPOCH + 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    mp.setattr(train_maskplanner, "train_step", step_then_sigterm)
    try:
        stopped, _ = train_maskplanner.main(
            [*RUN, f"device_dataset={stop_flag}",
             f"output_dir={tmp_path}/{name}"])
    finally:
        mp.undo()
    assert len(calls) == 2 * STEPS_PER_EPOCH
    blob = torch.load(os.path.join(stopped, "last_checkpoint.torch.pt"),
                      weights_only=True)
    assert blob["epoch"] == 2
    train_maskplanner.main([f"resume={stopped}",
                            f"device_dataset={resume_flag}"])
    return stopped


@pytest.fixture(scope="module")
def whole_run(tmp_path_factory):
    """The uninterrupted run on the default path (the device-resident
    epoch)."""
    from maskplanner_tpu_torch import train_maskplanner

    run_dir, _ = train_maskplanner.main(
        [*RUN, f"output_dir={tmp_path_factory.mktemp('whole')}"])
    return run_dir


@pytest.mark.parametrize("stop_flag,resume_flag", [
    ("false", "auto"), ("auto", "false")],
    ids=["host-then-device", "device-then-host"])
def test_resumed_run_is_bitwise_the_uninterrupted_device_run(
        stop_flag, resume_flag, whole_run, tmp_path):
    whole = whole_run
    resumed = _stopped_and_resumed(tmp_path, "stopped", stop_flag,
                                   resume_flag)
    assert _train_losses(resumed) == _train_losses(whole)
    a, b = (torch.load(os.path.join(r, "last_checkpoint.torch.pt"),
                       weights_only=True) for r in (resumed, whole))
    assert a["step"] == b["step"] == 3 * STEPS_PER_EPOCH
    for key in ("model", "optimizer", "lr_sched", "generator"):
        _assert_bitwise(a[key], b[key], key)


def _assert_bitwise(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_bitwise(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{what}/{i}")
    else:
        assert a == b, what


class _CardForm:
    """An optimizer whose ``state_dict`` has the card's form
    (``make_optimizer`` on the card: capturable, tensor LRs)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def state_dict(self):
        sd = self.optimizer.state_dict()
        for group in sd["param_groups"]:
            group["lr"] = torch.tensor(group["lr"])
            group["initial_lr"] = torch.tensor(group["lr"].item())
            group["capturable"] = True
        return sd


def test_optimizer_state_is_one_form_and_resumes():
    """A checkpoint's Adam state has one form whichever optimizer wrote it,
    and loads into an optimizer keeping that one's LR tensor in place."""
    from maskplanner_tpu_torch.convert import (load_optimizer_state,
                                               optimizer_state)

    def adam(lr):
        p = torch.nn.Parameter(torch.arange(4.0))
        return p, torch.optim.Adam([p], lr=lr)

    p, opt = adam(1e-2)
    for _ in range(2):
        p.grad = torch.ones(4)
        opt.step()
    host = optimizer_state(opt)
    card = optimizer_state(_CardForm(opt))
    # the card's LR is a float32 tensor
    assert card["param_groups"][0]["lr"] == float(np.float32(1e-2))
    assert card["param_groups"][0]["capturable"] is False
    assert isinstance(card["param_groups"][0]["initial_lr"], float)
    lr = torch.tensor(0.5)
    q, other = adam(lr)
    load_optimizer_state(other, card)
    assert other.param_groups[0]["lr"] is lr
    assert lr.item() == float(np.float32(1e-2))
    _assert_bitwise(optimizer_state(other)["state"], host["state"])
