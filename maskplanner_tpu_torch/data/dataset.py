"""Dataset pipeline with static-shape batching.

Mirrors the reference ``PaintNetODv1Dataloader`` item pipeline
(utils/dataset/paintnet_ODv1.py:185-484): center -> per-dataset scale ->
pc subsample -> equal-spacing resample (traj_sampling_v2/v3, subsample
variant) -> λ-segmentation -> stroke masks — but emits *fixed-size*
arrays with −100/−1 padding up to config-derived budgets instead of the
reference's per-batch dynamic padding (Paintnet_ODv1_CollateBatch,
:713-927). Static shapes mean a single XLA compilation covers every
batch; validity is carried by the padding conventions the loss layer
already understands.

Data sources: the synthetic generator (``data.synthetic``) or the on-disk
PaintNet layout (``data.io``) when ``$PAINTNET_ROOT`` exists.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from .pointcloud import (
    PAD_STROKE_ID,
    PAD_VALUE,
    get_dim_traj_points,
    get_sequences_of_lambda_points,
    resample_strokes_at_equal_spaced_points,
)
from .synthetic import SyntheticPaintDataset


def segment_budget(config) -> int:
    """Static GT-segment budget == the model's out_vectors formula
    (reference models/__init__.py:307-311)."""
    lam = config["lambda_points"]
    overlap = config["overlapping"]
    n_points = (config["n_pred_traj_points"]
                if config.get("traj_with_equally_spaced_points")
                else config["traj_points"])
    if lam == 1:
        return n_points
    return (n_points - lam) // (lam - overlap) + 1


def point_budget(config) -> int:
    """Static GT-pose budget."""
    return (config["n_pred_traj_points"]
            if config.get("traj_with_equally_spaced_points")
            else config["traj_points"])


class PaintDataset:
    """Map-style dataset producing fixed-shape numpy samples."""

    def __init__(self, config, split: str = "train", size: int | None = None):
        self.config = config
        self.split = split
        self.extra_data = list(config["extra_data"] or [])
        self.outdim = get_dim_traj_points(self.extra_data)
        self.lambda_points = int(config["lambda_points"])
        self.overlapping = int(config["overlapping"])
        self.pc_points = int(config["pc_points"])
        self.seg_budget = segment_budget(config)
        self.pt_budget = point_budget(config)
        self.max_n_strokes = int(config["max_n_strokes"])
        # augmentations apply to the train split only: the reference
        # passes ``augmentations`` just to the train dataset
        # (train_maskplanner.py:118 vs the te_dataset call without it)
        self.online_subsampling = split == "train" and (
            "pc_online_subsampling" in (config.get("augmentations") or []))
        self.overfitting = bool(config.get("overfitting"))
        self._cache: dict[int, dict] = {}
        self.cache_size = int(config.get("cache_size") or 0)

        categories = config["dataset"]
        if isinstance(categories, str):
            categories = [categories]
        self.categories = list(categories)

        root = os.environ.get("PAINTNET_ROOT")
        if root and os.path.isdir(root):
            from .io import DiskPaintDataset

            self.sources = [
                DiskPaintDataset(root, c, split,
                                 extra_data=tuple(self.extra_data),
                                 weight_orient=float(config["weight_orient"]))
                for c in self.categories
            ]
        else:
            default_size = size or (32 if split == "train" else 8)
            per_cat = max(1, default_size // len(self.categories))
            raw_points = self.pc_points * 2 if self.online_subsampling else self.pc_points
            self.sources = [
                SyntheticPaintDataset(c, split, per_cat, raw_points)
                for c in self.categories
            ]
        self._lengths = [len(s) for s in self.sources]

        # train_portion few-shot subsetting (reference paintnet_ODv1.py:172-177)
        portion = config.get("train_portion")
        if split == "train" and portion is not None:
            # the reference guards on `is not None` and then asserts the
            # subset is non-empty (paintnet_ODv1.py:172-177): fewshot.yaml
            # ships train_portion: 0.0 as a placeholder the user MUST
            # override on the CLI — silently training on the full set
            # would defeat the few-shot experiment
            assert float(portion) > 0, (
                f"train_portion={portion}: the fewshot config requires an "
                f"explicit CLI value, e.g. train_portion=0.1")
            self._lengths = [max(1, int(l * float(portion)))
                             for l in self._lengths]

        # per-dataset normalization scale (reference
        # utils/disk.py:16-43 hard-codes measured constants; for synthetic
        # data the scale is measured from a probe of samples)
        self.scale = self._compute_scale(config)

    def _compute_scale(self, config) -> float:
        if config.get("data_scale_factor"):
            return float(config["data_scale_factor"])
        if config.get("normalization") == "none":
            return 1.0
        # per-dataset: precomputed constants for the real categories
        # (reference utils/disk.py:16-43); measured for synthetic data
        from .io import DATASET_DOWNSCALE_FACTORS, get_dataset_name

        known = DATASET_DOWNSCALE_FACTORS.get(get_dataset_name(self.categories))
        if known is not None and os.environ.get("PAINTNET_ROOT"):
            return float(known)
        dists = []
        for src in self.sources:
            for i in range(min(4, len(src))):
                pc, _, _ = src.raw_item(i)
                pc = pc - pc.mean(axis=0)
                dists.append(np.linalg.norm(pc, axis=1).max())
        return float(np.mean(dists))

    def __len__(self):
        return sum(self._lengths)

    def item_name(self, index: int) -> str:
        """Stable per-item name for dumps/exports (the reference's
        ``dirnames``, mesh-dir names for disk data). Joint-category
        datasets prefix the category so same-named items from different
        sources cannot collide in per-name export files."""
        src, local = self._locate(index)
        base = (str(src.samples[local]) if hasattr(src, "samples")
                else f"{self.split}_{local}")
        if len(self.sources) > 1:
            return f"{self.categories[self.sources.index(src)]}_{base}"
        return base

    def _locate(self, index):
        for src, n in zip(self.sources, self._lengths):
            if index < n:
                return src, index
            index -= n
        raise IndexError(index)

    def __getitem__(self, index: int, rng: np.random.Generator | None = None):
        if self.overfitting:
            index = int(self.config.get("seed") or 0) % len(self)
        if index in self._cache:
            item = self._cache[index]
        else:
            item = self._materialize(index)
            if len(self._cache) < self.cache_size:
                self._cache[index] = item

        pc = item["point_cloud"]
        if self.online_subsampling:
            rng = rng or np.random.default_rng()
            choice = rng.choice(pc.shape[0], self.pc_points, replace=False)
            pc = pc[choice]
        out = dict(item)
        out["point_cloud"] = pc.astype(np.float32)
        return out

    def full_item(self, index: int) -> dict:
        """Materialized item with the FULL-resolution point cloud (the
        online subsample deliberately not applied) — the staging form for
        the device-resident augmentation path
        (``device_dataset.stage_device_dataset``), which re-draws the
        ``pc_points`` subset on device every step instead."""
        if self.overfitting:
            index = int(self.config.get("seed") or 0) % len(self)
        item = self._cache.get(index)
        if item is None:
            item = self._materialize(index)
            if len(self._cache) < self.cache_size:
                self._cache[index] = item
        out = dict(item)
        out["point_cloud"] = item["point_cloud"].astype(np.float32)
        return out

    def _materialize(self, index: int) -> dict:
        src, local = self._locate(index)
        pc, traj, stroke_ids = src.raw_item(local)
        cfg = self.config

        # center on the mesh vertex centroid when the source has a mesh
        # (reference ``center_pair``/``get_mean_mesh``,
        # utils/pointcloud.py:24-37); synthetic sources fall back to the
        # sampled-cloud centroid
        centroid = (np.asarray(src.centroid(local), pc.dtype)
                    if hasattr(src, "centroid") else pc.mean(axis=0))
        pc = (pc - centroid) / self.scale
        traj = traj.copy()
        traj[:, :3] = (traj[:, :3] - centroid) / self.scale

        if not self.online_subsampling and pc.shape[0] > self.pc_points:
            rng = np.random.default_rng(index)
            choice = rng.choice(pc.shape[0], self.pc_points, replace=False)
            pc = pc[choice]

        if cfg.get("traj_with_equally_spaced_points"):
            traj, stroke_ids = resample_strokes_at_equal_spaced_points(
                traj, stroke_ids,
                distance=float(cfg["equal_spaced_points_distance"]),
                interpolate=False,
                equal_in_3d_space=bool(cfg.get("equal_in_3d_space")),
            )
        else:
            choice = np.round(
                np.linspace(0, traj.shape[0] - 1, num=cfg["traj_points"])
            ).astype(int)
            traj, stroke_ids = traj[choice], stroke_ids[choice]

        traj = traj[:, : self.outdim]
        # clamp to the static pose budget (synthetic objects are generated
        # within budget; real data must satisfy n_pred_traj_points >= max)
        if traj.shape[0] > self.pt_budget:
            traj = traj[: self.pt_budget]
            stroke_ids = stroke_ids[: self.pt_budget]

        traj_as_pc = traj.copy()
        ids_as_pc = stroke_ids.astype(np.int64)

        if self.lambda_points > 1:
            segments, seg_ids = get_sequences_of_lambda_points(
                traj, ids_as_pc, self.lambda_points, dirname=f"sample{index}",
                overlapping=self.overlapping, extra_data=self.extra_data,
                padding=False,
            )
        else:
            segments, seg_ids = traj.copy(), ids_as_pc.copy()

        assert segments.shape[0] <= self.seg_budget, (
            f"{segments.shape[0]} segments exceed budget {self.seg_budget}"
        )

        # static-shape padding
        S, P = self.seg_budget, self.pt_budget
        traj_out = np.full((S, segments.shape[-1]), PAD_VALUE, np.float32)
        traj_out[: segments.shape[0]] = segments
        ids_out = np.full((S,), PAD_STROKE_ID, np.int64)
        ids_out[: seg_ids.shape[0]] = seg_ids
        pc_out = np.full((P, self.outdim), PAD_VALUE, np.float32)
        pc_out[: traj_as_pc.shape[0]] = traj_as_pc
        ids_pc_out = np.full((P,), PAD_STROKE_ID, np.int64)
        ids_pc_out[: ids_as_pc.shape[0]] = ids_as_pc

        n_strokes = len(np.unique(seg_ids[seg_ids >= 0]))
        # binary stroke masks (reference paintnet_ODv1.py:323-329)
        stroke_masks = (
            ids_out[None, :] == np.arange(self.max_n_strokes)[:, None]
        ).astype(np.float32)

        item = {
            "point_cloud": pc.astype(np.float32),
            "traj": traj_out,
            "stroke_ids": ids_out,
            "traj_as_pc": pc_out,
            "stroke_ids_as_pc": ids_pc_out,
            "stroke_masks": stroke_masks,
            "n_strokes": np.int32(n_strokes),
        }
        self._add_extras(item, segments, seg_ids, traj_as_pc, ids_as_pc, index)
        return item

    def _add_extras(self, item, segments, seg_ids, traj_as_pc, ids_as_pc,
                    index):
        """Optional load_extra_data items with static-shape padding
        (reference paintnet_ODv1.py:360-484)."""
        from . import extras

        cfg = self.config
        load = set(cfg.get("load_extra_data") or [])
        M = self.max_n_strokes

        if "stroke_prototypes" in load or cfg.get("load_stroke_prototypes"):
            protos, order = extras.get_stroke_prototypes(
                traj_as_pc, ids_as_pc,
                kind=cfg.get("stroke_prototype_kind", "start_of_path_token"),
                outdim=self.outdim,
                start_of_path_token_length=int(
                    cfg.get("start_of_path_token_length") or 4))
            item["stroke_prototypes"] = extras.pad_prototypes(protos, M)

        if "segments_per_stroke" in load:
            sps, order2 = extras.get_vectors_per_stroke(segments, seg_ids)
            pps, _ = extras.get_vectors_per_stroke(traj_as_pc, ids_as_pc)
            max_seg = int(cfg.get("out_segments_per_stroke")
                          or max(s.shape[0] for s in sps))
            max_pts = int(cfg.get("out_points_per_stroke")
                          or max(p.shape[0] for p in pps))
            item["segments_per_stroke"], item["stroke_valid"] = \
                extras.pad_vectors_per_stroke(sps, M, max_seg)
            item["points_per_stroke"], _ = \
                extras.pad_vectors_per_stroke(pps, M, max_pts)

        if ("history_of_segments_per_stroke_v2" in load
                and cfg.get("substroke_points")):
            sps, order2 = extras.get_vectors_per_stroke(segments, seg_ids)
            hist, tgt, pid, eop = extras.history_batches_v2(
                sps, order2, int(cfg["substroke_points"]))
            if (self.split == "train"
                    and "general_noise" in (cfg.get("augmentations") or [])
                    and cfg.get("sample_substroke_v2")):
                # noisy teacher forcing (reference paintnet_ODv1.py:429-448)
                hist = extras.add_history_noise(
                    hist, self.lambda_points, self.outdim,
                    float(cfg.get("trasl_noise_stdev") or 0.01),
                    float(cfg.get("orient_noise_stdev") or 0.01),
                    float(cfg["weight_orient"]),
                    np.random.default_rng(index))
            item["strokewise_history_batch"] = hist.astype(np.float32)
            item["strokewise_target_batch"] = tgt.astype(np.float32)
            item["strokewise_stroke_ids_batch"] = pid
            item["strokewise_end_of_path_batch"] = eop


def collate(items: list[dict]) -> dict:
    """Stack fixed-shape items into a batch (all shapes already static)."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class DataLoader:
    """Minimal deterministic batch iterator (single host process).

    The reference uses torch DataLoader with worker processes
    (train_maskplanner.py:134-148); here item materialization is cached
    after the first epoch so steady-state batching is a cheap stack, and
    batches feed an on-device prefetch in the trainer.
    """

    def __init__(self, dataset: PaintDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 num_shards: int = 1, shard_index: int = 0):
        """``num_shards``/``shard_index``: multi-host data parallelism —
        every host computes the same seeded global permutation and takes its
        interleaved slice, yielding per-host batches of
        ``batch_size // num_shards`` rows (feed ``shard_batch_global``)."""
        assert batch_size % num_shards == 0, (batch_size, num_shards)
        assert num_shards == 1 or drop_last, (
            "multi-host loading requires drop_last (uneven final batches "
            "would desynchronize per-process shapes)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        rng = np.random.default_rng(self.seed + epoch)
        if self.shuffle:
            rng.shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        local_bs = self.batch_size // self.num_shards
        for start in range(0, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.num_shards > 1:
                idx = idx[self.shard_index * local_bs:
                          (self.shard_index + 1) * local_bs]
            # dataset indices of the batch about to be yielded (consumed
            # by the eval loop for real per-item dump names)
            self.last_indices = np.asarray(idx)
            yield collate([self.dataset.__getitem__(int(i), rng=rng)
                           for i in idx])

    def __iter__(self):
        return self.epoch(0)
