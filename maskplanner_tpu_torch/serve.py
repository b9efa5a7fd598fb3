"""Serving: a trained run -> mesh-to-program inference
(``maskplanner_tpu/serve.py``).

The host steps are the JAX package's own modules, imported as they are:
mesh sampling and normalization (``data.io``), the stroke-mask
postprocess (``postprocess``), denormalization and the orientnorm -> Euler
export (``data.pointcloud``, ``data.io``). The forward is the port's model on
an explicit device; ``device="cuda"`` without a card raises, and nothing
falls back to the CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from maskplanner_tpu.data.io import (get_mean_mesh, orientnorm_to_euler,
                                     read_mesh_as_pointcloud, save_traj_file)
from maskplanner_tpu.data.pointcloud import (denormalize_traj,
                                             get_dim_traj_points)
from maskplanner_tpu.postprocess import process_pred_stroke_masks_to_stroke_ids
from maskplanner_tpu.postprocess.segments import process_stroke_segments
from maskplanner_tpu.serve import resolve_scale
from maskplanner_tpu.utils.config import (apply_retrocompat_defaults,
                                          load_config)

from .convert import checkpoint_name, load_checkpoint
from .models import MaskPlannerOutput, get_model


def resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but no CUDA device "
                           "is available")
    return device


class Predictor:
    """A loaded run: frozen config + port checkpoint + the model on
    ``device``.

    >>> pred = Predictor(run_dir, model="last", device="cuda")
    >>> rows = pred.predict_program("window_031.obj")  # (N, 7) X..C+strokeId
    """

    def __init__(self, run_dir: str, model: str = "last", *,
                 device: str | torch.device,
                 data_scale_factor: float | None = None):
        self.device = resolve_device(device)
        self.run_dir = run_dir
        self.config = apply_retrocompat_defaults(load_config(run_dir))
        self.pc_points = int(self.config["pc_points"])
        self.extra_data = list(self.config["extra_data"])
        self.outdim = get_dim_traj_points(self.extra_data)
        self.scale = resolve_scale(self.config, data_scale_factor)
        self.model = get_model(self.config, device="cpu")
        self.epoch = load_checkpoint(run_dir, checkpoint_name(model),
                                     self.model)
        self.model.to(self.device)

    def preprocess(self, mesh_file: str, n_raw_points: int = 10000):
        """OBJ -> (normalized (pc_points, 3) float32 cloud, centroid)."""
        pc = read_mesh_as_pointcloud(mesh_file, n_raw_points)
        centroid = get_mean_mesh(mesh_file)
        pc = (pc - centroid) / self.scale
        if pc.shape[0] > self.pc_points:
            choice = np.random.default_rng(0).choice(
                pc.shape[0], self.pc_points, replace=False)
            pc = pc[choice]
        if pc.shape[0] != self.pc_points:
            raise ValueError(f"mesh yielded {pc.shape[0]} < pc_points="
                             f"{self.pc_points} samples; raise n_raw_points")
        return pc.astype(np.float32), centroid

    def forward(self, pc_batch) -> MaskPlannerOutput:
        """Model forward on a (B, pc_points, 3) normalized batch; the
        outputs stay on the device."""
        x = torch.as_tensor(np.asarray(pc_batch, np.float32),
                            device=self.device)
        with torch.inference_mode():
            return self.model(x)

    def predict_program(self, mesh_file: str, postprocess: bool = True,
                        keep_centroid: bool = True, cover_all: bool = True):
        """Mesh file -> rows (N, 7) at workspace scale: X;Y;Z;A;B;C;strokeId.

        sample + normalize -> forward -> stroke-mask postprocess ->
        denormalize -> orientnorm -> Euler. ``cover_all`` (the serving
        default) executes every predicted segment by splitting the segments
        off the Edmonds path into sub-strokes."""
        if "orientnorm" not in self.extra_data:
            raise ValueError("program export needs orientnorm poses")
        pc, centroid = self.preprocess(mesh_file)
        out = self.forward(pc[None])
        traj = out.traj.cpu().numpy().astype(np.float64)
        ids = process_pred_stroke_masks_to_stroke_ids(
            out.stroke_masks.cpu().numpy(), out.mask_scores.cpu().numpy())
        if postprocess:
            trajs, out_ids = process_stroke_segments(traj, ids, self.config,
                                                     cover_all=cover_all)
            pts, pt_ids = np.asarray(trajs[0]), np.asarray(out_ids[0])
        else:
            rows, rid = traj[0], np.asarray(ids[0])
            valid = ~np.all(rows == -100.0, axis=-1)
            lam = rows.shape[-1] // self.outdim
            pts = rows[valid].reshape(-1, self.outdim)
            pt_ids = np.repeat(rid[valid], lam)
        pts = denormalize_traj(
            pts, centroid=centroid if keep_centroid else np.zeros(3),
            scale=self.scale, weight_orient=self.config["weight_orient"])
        euler = orientnorm_to_euler(pts[:, 3:6])
        return np.concatenate(
            [pts[:, :3], euler, np.asarray(pt_ids, np.float64)[:, None]],
            axis=1)

    def save_program(self, mesh_file: str, out_path: str, **kw) -> str:
        rows = self.predict_program(mesh_file, **kw)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        save_traj_file(rows, out_path, kind="euler")
        return out_path
