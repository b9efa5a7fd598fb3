"""The training split staged on the device, for the device-resident epoch
(``maskplanner_tpu/data/device_dataset.py``).

PaintNet categories are small (hundreds of meshes; the synthetic mirror
matches), so the whole training split fits on the card. Staged once, each
epoch gathers its batches there (``train.trainer.DeviceEpoch``) and the
host syncs once an epoch. Batch composition is the host ``DataLoader``'s:
:func:`epoch_perm` is the loader's seeded numpy shuffle, and only the
gather moves to the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .dataset import collate

_DEFAULT_BYTE_LIMIT = 2 << 30  # 2 GiB of device memory for the staged split


def device_dataset_eligible(config, n_devices: int,
                            batch_size: int | None = None) -> bool:
    """Whether the device-resident epoch applies, as the JAX package rules:
    not with ``device_dataset=false``; with several devices only when the
    batch divides over them; with no augmentation but
    ``pc_online_subsampling`` (whose draw moves to the device); with no
    adversarial loss."""
    flag = str(config.get("device_dataset", "auto")).lower()
    if flag == "false":
        return False
    if n_devices > 1 and (batch_size is None
                          or batch_size % n_devices != 0):
        return False
    augs = list(config.get("augmentations") or [])
    if augs and augs != ["pc_online_subsampling"]:
        return False
    if any(n in ("discriminator", "wdiscriminator")
           for n in config["loss"]):
        return False
    return True


def stage_device_dataset(dataset, byte_limit: int = _DEFAULT_BYTE_LIMIT,
                         device="cuda") -> dict[str, torch.Tensor] | None:
    """Materialise and stack the whole split (``data.collate``) and put it
    on ``device`` -> a dict of tensors, or None when the stacked split
    exceeds ``byte_limit`` bytes.

    Under ``pc_online_subsampling`` the clouds are staged at full
    resolution (the epoch draws each step's ``pc_points`` subset on the
    device), unified to the smallest cloud, at most 2 x ``pc_points``, by a
    seeded pre-subsample of each larger item (``default_rng(i)``)."""
    if getattr(dataset, "online_subsampling", False):
        items = [dataset.full_item(i) for i in range(len(dataset))]
        raw = min(min(it["point_cloud"].shape[0] for it in items),
                  2 * dataset.pc_points)
        for i, it in enumerate(items):
            pc = it["point_cloud"]
            if pc.shape[0] > raw:
                choice = np.random.default_rng(i).choice(
                    pc.shape[0], raw, replace=False)
                it["point_cloud"] = pc[choice]
    else:
        items = [dataset[i] for i in range(len(dataset))]
    stacked = collate(items)
    if sum(v.nbytes for v in stacked.values()) > byte_limit:
        return None
    return {k: torch.from_numpy(v).to(device) for k, v in stacked.items()}


def staged_bytes(data: dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in data.values())


def epoch_perm(n: int, batch_size: int, seed: int, epoch: int,
               shuffle: bool = True) -> np.ndarray:
    """(steps, batch) int32 index matrix: the batches the host
    ``DataLoader.epoch`` yields (the same seeded numpy shuffle, the last
    partial batch dropped)."""
    order = np.arange(n)
    rng = np.random.default_rng(seed + epoch)
    if shuffle:
        rng.shuffle(order)
    steps = n // batch_size
    return order[: steps * batch_size].reshape(
        steps, batch_size).astype(np.int32)
