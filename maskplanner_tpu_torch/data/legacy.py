"""Legacy single-path PaintNet dataset (reference ``utils/dataset/paintnet.py``;
the port's copy of ``maskplanner_tpu/data/legacy.py``, numpy only).

The reference keeps an older loader, ``PaintNetDataloader``
(utils/dataset/paintnet.py:22-363), alongside the live ODv1 one. No
driver imports it, but it is the only home of three capabilities the
ODv1 loader dropped or deprecated:

* per-epoch rotation augmentations (``rot`` = full SO(3), ``roty``,
  ``rotx``; paintnet.py:265-325),
* velocity extra-data at ``lambda_points == 1`` (paintnet.py:252-255),
* ``stroke_pred`` per-stroke downsampling feeding the strokeRollout
  ``mse_strokes`` loss (paintnet.py:225-231).

This module re-provides that surface on the repo's numpy pipeline. It
returns the reference's exact item tuple
``(point_cloud, traj, traj_as_pc, stroke_ids, dirname)`` so legacy
consumers can port 1:1; the live trainer keeps using
:class:`maskplanner_tpu_torch.data.dataset.PaintDataset`.

Known reference defects handled here (see PARITY.md):

* paintnet.py:287 stores ``traj_as_pc`` in the cache tuple, but the
  ``stroke_pred`` branch never assigns it -> NameError in the original.
  Here ``traj_as_pc`` is the per-stroke downsampled poses in flat
  (N, outdim) form, which is what the rollout metrics consume.
* paintnet.py:306-310 applies ``rot.apply`` to the orientation columns;
  that is only a valid group action for 3-vector representations
  (``orientnorm``/``orientrotvec``). Quaternions would need a
  composition, so ``orientquat`` + rotation augmentation raises here
  instead of silently corrupting labels.

Reference quirk reproduced as-is: under rotation augmentation with
``lambda_points > 1`` the reference repacks ``traj_as_pc`` into padded
segment format (paintnet.py:307-308), so augmented items return
``traj_as_pc`` as (S, outdim*lambda) while unaugmented items keep the
flat (traj_points, outdim) form.
"""
from __future__ import annotations

import os

import numpy as np

from .io import (
    DiskPaintDataset,
    get_dataset_downscale_factor,
    get_max_distance,
    get_mean_mesh,
)
from .pointcloud import (
    add_padding,
    downsample_strokes,
    get_dim_traj_points,
    get_sequences_of_lambda_points,
    get_traj_feature_index,
    get_velocities,
    orient_in,
    remove_padding,
)

_ROT_AUGS = ("rot", "roty", "rotx")


class LegacyPaintDataset:
    """Reference-parity legacy loader (utils/dataset/paintnet.py:22-363).

    Parameters mirror the reference constructor; ``root`` is the dataset
    root holding one directory per category (``$PAINTNET_ROOT`` layout).
    """

    def __init__(self, root: str, categories, split: str = "train",
                 pc_points: int = 5120, traj_points: int = 500,
                 lambda_points: int = 1, overlapping: int = 0,
                 stroke_pred: bool = False, stroke_points: int = 100,
                 extra_data=(), weight_orient: float = 1.0,
                 cache_size: int = 2000, overfitting: int | None = None,
                 augmentations=(), normalization: str = "per-mesh",
                 data_scale_factor: float | None = None,
                 train_portion: float | None = None, seed: int = 0):
        if isinstance(categories, str):
            categories = [categories]
        self.categories = list(categories)
        self.pc_points = int(pc_points)
        self.traj_points = int(traj_points)
        self.lambda_points = int(lambda_points)
        self.overlapping = int(overlapping)
        self.stroke_pred = bool(stroke_pred)
        self.stroke_points = int(stroke_points)
        self.extra_data = list(extra_data or [])
        self.weight_orient = float(weight_orient)
        self.cache_size = int(cache_size)
        self.overfitting = overfitting
        self.augmentations = list(augmentations or [])
        self.normalization = normalization
        self._cache: dict[int, tuple] = {}

        # sanity checks (paintnet.py:97-119)
        assert lambda_points > overlapping, \
            "Overlapping can not be equal or lower than lambda"
        assert overlapping >= 0
        assert train_portion is None or 0 < float(train_portion) <= 1
        bad = set(self.extra_data) - {"vel", "orientquat", "orientrotvec",
                                      "orientnorm"}
        if bad:
            raise ValueError(f"extra_data not allowed: {sorted(bad)}")
        assert not ("vel" in self.extra_data and orient_in(self.extra_data)[0]), \
            "vel and orientations together are not compatible"
        assert set(self.augmentations) <= set(_ROT_AUGS), \
            f"unavailable augmentation in {self.augmentations}"
        assert normalization in ("none", "per-mesh", "per-dataset"), \
            f"invalid normalization {normalization!r}"
        if (self.augmentations and orient_in(self.extra_data)[0]
                and orient_in(self.extra_data)[1] == "orientquat"):
            raise NotImplementedError(
                "rotation augmentation of quaternion labels needs a "
                "quaternion composition; the reference's rot.apply on the "
                "quat columns (paintnet.py:306-310) is not a group action")

        # data-loading extras are stripped from DiskPaintDataset's cache
        # key: the legacy loader caches pre-subsample full-dim data
        self.sources = [
            DiskPaintDataset(root, c, split,
                             extra_data=tuple(self.extra_data),
                             weight_orient=self.weight_orient)
            for c in self.categories
        ]
        self._items: list[tuple] = []  # (source_idx, local_idx)
        for si, src in enumerate(self.sources):
            self._items += [(si, li) for li in range(len(src))]

        if split == "train" and train_portion is not None:
            # paintnet.py:166-171 — shuffled subset for few-shot runs
            rng = np.random.default_rng(seed)
            rng.shuffle(self._items)
            self._items = self._items[: max(
                1, int(float(train_portion) * len(self._items)))]
        assert self._items, "dataset resolved to zero samples"

        # per-dataset scale (paintnet.py:119-126, 174-176): precomputed
        # constant, explicit override, or mean max-distance over meshes
        self.dataset_mean_max_distance = None
        if normalization == "per-dataset":
            if data_scale_factor is not None:
                self.dataset_mean_max_distance = float(data_scale_factor)
            else:
                name = "-".join(self.categories)
                known = get_dataset_downscale_factor(name)
                if known is not None:
                    self.dataset_mean_max_distance = float(known)
                else:
                    dists = [get_max_distance(self._mesh_path(i))
                             for i in range(len(self._items))]
                    self.dataset_mean_max_distance = float(np.mean(dists))

    def __len__(self):
        return len(self._items)

    def _mesh_path(self, index: int) -> str:
        si, li = self._items[index]
        src = self.sources[si]
        mesh, _ = src._paths(src.samples[li])
        return mesh

    def dirname(self, index: int) -> str:
        si, li = self._items[index]
        return str(self.sources[si].samples[li])

    # ------------------------------------------------------------------
    def _materialize(self, index: int, rng: np.random.Generator):
        """Disk -> normalized, subsampled, (optionally) segmented item
        (paintnet.py:178-288, minus the per-epoch augmentations)."""
        si, li = self._items[index]
        src = self.sources[si]
        pc, traj, stroke_ids = src.raw_item(li)
        pc = np.asarray(pc, np.float64)
        traj = np.asarray(traj, np.float64)
        mesh_file = self._mesh_path(index)

        # zero-mean on the mesh-vertex centroid + scale (paintnet.py:188-200)
        centroid = get_mean_mesh(mesh_file)
        pc = pc - centroid
        traj = traj.copy()
        traj[:, :3] -= centroid
        if self.normalization == "per-dataset":
            scale = self.dataset_mean_max_distance
        elif self.normalization == "per-mesh":
            scale = get_max_distance(mesh_file)
        else:
            scale = 1.0
        pc /= scale
        traj[:, :3] /= scale

        assert pc.shape[0] >= self.pc_points, \
            f"mesh sampling produced {pc.shape[0]} < pc_points={self.pc_points}"
        choice = rng.choice(pc.shape[0], self.pc_points, replace=False)
        pc = pc[choice]

        outdim = get_dim_traj_points(self.extra_data)
        traj = traj[:, :outdim]

        if self.stroke_pred:
            # per-stroke uniform downsample (paintnet.py:225-231):
            # strokes with length <= stroke_points are dropped and the
            # rest renumbered (reference downsample_strokes semantics).
            # The flat poses double as traj_as_pc (reference defect, see
            # module docstring).
            pts, ids = downsample_strokes(traj, stroke_ids,
                                          self.stroke_points)
            traj_out = pts.reshape(pts.shape[0],
                                   self.stroke_points * outdim)
            return (pc, traj_out, pts.reshape(-1, outdim).copy(),
                    ids.reshape(-1), self.dirname(index))

        # equal-interval subsample to traj_points (paintnet.py:233-236)
        sel = np.round(np.linspace(0, traj.shape[0] - 1,
                                   num=self.traj_points)).astype(int)
        traj, stroke_ids = traj[sel], stroke_ids[sel]
        traj_as_pc = traj.copy()

        if self.lambda_points > 1:
            traj, stroke_ids = get_sequences_of_lambda_points(
                traj, stroke_ids, self.lambda_points,
                dirname=self.dirname(index), overlapping=self.overlapping,
                extra_data=self.extra_data, padding=True)

        if "vel" in self.extra_data:
            # paintnet.py:252-255 — forward-difference velocities
            assert self.lambda_points == 1, \
                "velocities are only defined for lambda_points == 1"
            traj = np.concatenate(
                [traj, get_velocities(traj, stroke_ids)], axis=-1)

        return pc, traj, traj_as_pc, stroke_ids, self.dirname(index)

    def _augment(self, pc, traj, traj_as_pc):
        """Fresh random rotation per access (paintnet.py:265-325)."""
        from scipy.spatial.transform import Rotation as Rot

        if "roty" in self.augmentations:
            rot = Rot.from_euler("y", np.random.uniform(-np.pi, np.pi))
        elif "rotx" in self.augmentations:
            rot = Rot.from_euler("x", np.random.uniform(-np.pi, np.pi))
        else:
            rot = Rot.random()

        outdim = get_dim_traj_points(self.extra_data)
        pc = rot.apply(pc)
        has_orient, kind = orient_in(self.extra_data)
        oidx = (get_traj_feature_index(kind, self.extra_data)
                if has_orient else None)

        def rot_flat(rows):
            rows = rows.copy()
            rows[:, :3] = rot.apply(rows[:, :3])
            if oidx is not None:
                rows[:, oidx] = rot.apply(rows[:, oidx])
            elif "vel" in self.extra_data and rows.shape[1] >= 6:
                rows[:, 3:6] = rot.apply(rows[:, 3:6])
            return rows

        if self.lambda_points > 1:
            # unpad -> rotate poses -> repack -> repad (paintnet.py:276-315)
            flat = remove_padding(traj.reshape(-1, outdim), self.extra_data)
            flat = rot_flat(flat)
            traj = add_padding(flat.reshape(-1, outdim * self.lambda_points),
                               traj_points=self.traj_points,
                               lmbda=self.lambda_points,
                               overlapping=self.overlapping)
            # the reference ALSO repacks traj_as_pc into padded segment
            # format here (paintnet.py:307-308) — so augmented lambda>1
            # items carry traj_as_pc as (S, outdim*lambda) while
            # unaugmented items keep the flat (traj_points, outdim) form;
            # reproduced exactly for the 1:1 item-tuple contract
            traj_as_pc = rot_flat(traj_as_pc)
            traj_as_pc = add_padding(
                traj_as_pc.reshape(-1, outdim * self.lambda_points),
                traj_points=self.traj_points, lmbda=self.lambda_points,
                overlapping=self.overlapping)
        else:
            traj = rot_flat(traj)
            traj_as_pc = rot_flat(traj_as_pc)
        return pc, traj, traj_as_pc

    def __getitem__(self, index: int,
                    rng: np.random.Generator | None = None):
        if self.overfitting is not None:
            index = int(self.overfitting)
        if index in self._cache:
            pc, traj, traj_as_pc, stroke_ids, dirname = self._cache[index]
        else:
            item_rng = np.random.default_rng(index) if rng is None else rng
            pc, traj, traj_as_pc, stroke_ids, dirname = \
                self._materialize(index, item_rng)
            if len(self._cache) < self.cache_size:
                self._cache[index] = (pc, traj, traj_as_pc, stroke_ids,
                                      dirname)
        pc, traj, traj_as_pc, stroke_ids = (
            pc.copy(), traj.copy(), traj_as_pc.copy(), stroke_ids.copy())
        if self.augmentations and not self.stroke_pred:
            pc, traj, traj_as_pc = self._augment(pc, traj, traj_as_pc)
        return pc, traj, traj_as_pc, stroke_ids, dirname
