"""Serving: a trained run -> mesh-to-program inference
(``maskplanner_tpu/serve.py``).

The host steps are the port's own copies of the JAX package's numpy-only
modules: mesh sampling and normalization (``data.io``), the stroke-mask
postprocess (``postprocess``), denormalization and the orientnorm -> Euler
export (``data.pointcloud``, ``data.io``), and ``resolve_scale``. The
forward is the port's model on the card unless the caller asks for the
CPU; ``device="cuda"`` without a card raises, and nothing falls back to the
CPU.

:meth:`Predictor.export_compiled` writes the eval forward as a
``torch.export`` program with the weights in it (its kernels as the custom
ops of ``ops.library``), and :func:`load_exported` serves from that file
with no config, checkpoint or model code: it needs only the op library.
The file is a header (magic, SHA-256 digest, metadata) before the archive
that ``torch.export.save`` writes; a file whose bytes do not match the
digest raises. A file for several devices (the JAX CLI's ``--platforms tpu
cpu``) holds one archive a device, each traced on its device, one after
the other (the metadata's ``devices`` and ``sizes``); it is sealed as one.

A ``Predictor`` loads a run of any backbone that ``models.get_model``
builds and serves its ``forward``; the program export and the exported
forward need the stroke-mask models' outputs, and raise for any other.
"""
from __future__ import annotations

import copy
import hashlib
import io
import json
import os
import struct

import numpy as np
import torch
from torch import nn

from .convert import checkpoint_name, load_checkpoint
from .data.io import (DATASET_DOWNSCALE_FACTORS, get_dataset_name,
                      get_mean_mesh, orientnorm_to_euler,
                      read_mesh_as_pointcloud, save_traj_file)
from .data.pointcloud import denormalize_traj, get_dim_traj_points
from .models import STROKE_MASK_BACKBONES, MaskPlannerOutput, get_model
from .models.maskplanner import f32_accumulation
from .postprocess import process_pred_stroke_masks_to_stroke_ids
from .postprocess.segments import process_stroke_segments
from .utils.config import apply_retrocompat_defaults, load_config


def resolve_scale(config, data_scale_factor: float | None = None,
                  allow_probe: bool = True) -> float:
    """Workspace -> model-space downscale factor for a frozen run config.

    Resolution order: explicit override > frozen ``data_scale_factor`` >
    the per-category measured constant (reference utils/disk.py:16-43) >
    a dataset probe (same rule as ``PaintDataset._compute_scale``, needs
    the dataset on disk). ``normalization: none`` is always 1.0.
    """
    if data_scale_factor:
        return float(data_scale_factor)
    if config.get("normalization") == "none":
        return 1.0
    if config.get("data_scale_factor"):
        return float(config["data_scale_factor"])
    known = DATASET_DOWNSCALE_FACTORS.get(get_dataset_name(config["dataset"]))
    if known is not None:
        return float(known)
    if allow_probe:
        from .data.dataset import PaintDataset

        probe = config.copy()
        probe["data_scale_factor"] = None
        return float(PaintDataset(probe, split="train").scale)
    raise ValueError(
        f"no downscale factor known for {config['dataset']}; pass "
        f"data_scale_factor explicitly")


def resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but no CUDA device "
                           "is available")
    return device


class Predictor:
    """A loaded run: frozen config + port checkpoint + the model on
    ``device``.

    >>> pred = Predictor(run_dir, model="last", compute_dtype="bf16")
    >>> rows = pred.predict_program("window_031.obj")  # (N, 7) X..C+strokeId

    ``compute_dtype``: None keeps the run's dtype (``model.bf16``); "bf16"
    or "f32" sets the forward's. The parameters are f32 either way, so
    every checkpoint loads under either."""

    def __init__(self, run_dir: str, model: str = "last", *,
                 device: str | torch.device = "cuda",
                 data_scale_factor: float | None = None,
                 compute_dtype: str | None = None):
        self.device = resolve_device(device)
        self.run_dir = run_dir
        self.config = apply_retrocompat_defaults(load_config(run_dir))
        if compute_dtype is not None:
            if compute_dtype not in ("bf16", "f32"):
                raise ValueError(f"compute_dtype must be None, 'bf16' or "
                                 f"'f32', got {compute_dtype!r}")
            self.config["model"]["bf16"] = compute_dtype == "bf16"
        self.pc_points = int(self.config["pc_points"])
        self.extra_data = list(self.config["extra_data"])
        self.outdim = get_dim_traj_points(self.extra_data)
        self.scale = resolve_scale(self.config, data_scale_factor)
        self.model = get_model(self.config, device="cpu")
        self.epoch = load_checkpoint(run_dir, checkpoint_name(model),
                                     self.model)
        self.model.to(self.device)
        self.exported = None

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

    def _needs_masks(self, what: str) -> None:
        """Raise for a run whose model has no stroke masks."""
        backbone = self.config["model"]["backbone"]
        if backbone not in STROKE_MASK_BACKBONES:
            raise ValueError(
                f"{what} needs a stroke-mask model "
                f"({', '.join(STROKE_MASK_BACKBONES)}); this is a {backbone} "
                f"run: serve its forward, or score it with test_maskplanner")

    def forward(self, pc_batch) -> MaskPlannerOutput | torch.Tensor:
        """Model forward on a (B, pc_points, 3) normalized batch, or the
        exported program's after :meth:`serve_exported` -> what the model
        returns: a ``MaskPlannerOutput``, or the plain segment tensor of a
        ``pointnet2`` run (``models.PointNet2Regressor``); the outputs stay
        on the device."""
        if self.exported is not None:
            return MaskPlannerOutput(*self.exported(pc_batch))
        x = torch.as_tensor(np.asarray(pc_batch, np.float32),
                            device=self.device)
        with torch.inference_mode():
            return self.model(x)

    def export_compiled(self, path: str, batch: int = 1,
                        devices: list | None = None) -> bytes:
        """Write the eval forward at batch ``batch`` in the Predictor's
        compute dtype, traced by ``torch.export.export`` with the weights
        in the program, to ``path`` -> the file's bytes. Serve it with
        :func:`load_exported`; a program traced for the card runs on the
        card only.

        ``devices`` (default: the Predictor's; e.g. ``["cuda", "cpu"]``):
        the file holds one program for each, each traced on its device,
        and :func:`load_exported` picks the one it is asked for. Every
        device is resolved before anything is traced or written (``cuda``
        without a card raises). A run without stroke masks raises: the
        JAX export of such a run takes ``tuple(...)`` of the model's
        segment array, which splits it along the batch
        (``maskplanner_tpu/serve.py:203-204``), so its artefact is not a
        serving forward either."""
        self._needs_masks("the exported forward")
        targets = [resolve_device(d) for d in (devices or [self.device])]
        kinds = [d.type for d in targets]
        if len(set(kinds)) != len(kinds):
            raise ValueError(f"devices {kinds}: name each device once")
        archives = [self._traced(d, batch) for d in targets]
        meta = {"batch": int(batch), "pc_points": self.pc_points,
                "dtype": "bf16" if self.config["model"].get("bf16")
                else "f32"}
        if len(kinds) == 1:
            meta = {"device": kinds[0], **meta}
        else:
            meta = {"devices": kinds, "sizes": [len(a) for a in archives],
                    **meta}
        blob = _seal(json.dumps(meta).encode(), b"".join(archives))
        with open(path, "wb") as fh:
            fh.write(blob)
        return blob

    def _traced(self, device: torch.device, batch: int) -> bytes:
        """The eval forward traced on ``device`` -> its
        ``torch.export.save`` archive."""
        model = _ServingForward(self.model).to(device)
        example = torch.zeros((batch, self.pc_points, 3), dtype=torch.float32,
                              device=device)
        with torch.no_grad():
            program = torch.export.export(model, (example,))
        archive = io.BytesIO()
        torch.export.save(program, archive)
        return archive.getvalue()

    def serve_exported(self, path: str) -> None:
        """Serve every later request's forward from the program at ``path``
        (:meth:`export_compiled`) on the Predictor's device."""
        self.exported = load_exported(path, self.device)

    def predict_program(self, mesh_file: str, postprocess: bool = True,
                        keep_centroid: bool = True, cover_all: bool = True):
        """Mesh file -> rows (N, 7) at workspace scale: X;Y;Z;A;B;C;strokeId.

        sample + normalize -> forward -> stroke-mask postprocess ->
        denormalize -> orientnorm -> Euler. ``cover_all`` (the serving
        default) executes every predicted segment by splitting the segments
        off the Edmonds path into sub-strokes."""
        self._needs_masks("a program")
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


class _ServingForward(nn.Module):
    """A frozen copy of the model whose forward returns the tuple
    ``(traj, stroke_masks, mask_scores, seg_confidence)``: no parameter
    asks for a gradient, so the levels call the custom ops."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = copy.deepcopy(model).eval()
        self.model.requires_grad_(False)

    def forward(self, xyz: torch.Tensor):
        return tuple(self.model(xyz))


_MAGIC = b"MPTORCHX"
_HEADER = struct.Struct("<8s32sI")    # magic, SHA-256, metadata bytes


def _seal(meta: bytes, archive: bytes) -> bytes:
    body = meta + archive
    return _HEADER.pack(_MAGIC, hashlib.sha256(body).digest(),
                        len(meta)) + body


def _unseal(blob: bytes, path: str) -> tuple[dict, bytes]:
    """The metadata and the archive of an exported forward, after the
    digest check."""
    if len(blob) < _HEADER.size:
        raise ValueError(f"{path}: {len(blob)} bytes, not an exported "
                         f"forward")
    magic, digest, n_meta = _HEADER.unpack_from(blob)
    body = blob[_HEADER.size:]
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an exported forward")
    if hashlib.sha256(body).digest() != digest:
        raise ValueError(f"{path}: the exported forward is corrupt (its "
                         f"digest does not match its bytes)")
    return json.loads(body[:n_meta]), body[n_meta:]


def _program_for(meta: dict, archive: bytes, path: str,
                 device: str | torch.device | None) -> tuple:
    """The archive of the program for ``device`` in an exported file and
    that device's type -> (device type, archive, the metadata of that
    program). A file for several devices without ``device`` gives the
    first of its devices that this process has (``cuda`` needs a card)."""
    want = None if device is None else torch.device(device).type
    if "devices" not in meta:
        if want is not None and want != meta["device"]:
            raise ValueError(f"{path} was exported for {meta['device']}, "
                             f"not for {want}: export it again")
        return meta["device"], archive, meta
    held = meta["devices"]
    if want is None:
        have = [d for d in held
                if d != "cuda" or torch.cuda.is_available()]
        if not have:
            raise RuntimeError(f"{path} holds programs for {held}, none of "
                               f"which this process has")
        want = have[0]
    if want not in held:
        raise ValueError(f"{path} holds programs for {', '.join(held)}, not "
                         f"for {want}: export it again")
    i = held.index(want)
    start = sum(meta["sizes"][:i])
    own = {k: v for k, v in meta.items() if k not in ("devices", "sizes")}
    return want, archive[start:start + meta["sizes"][i]], {
        "device": want, "devices": held, **own}


def load_exported(path: str, device: str | torch.device | None = None):
    """Load a :meth:`Predictor.export_compiled` file -> ``fn(pc_batch) ->
    (traj, stroke_masks, mask_scores, seg_confidence)`` (``pc_batch`` a
    numpy array or a tensor) on the device it was
    traced for (``device``, when given, must be that one; in a file for
    several devices, the program for ``device``, which the file must
    hold). No config, checkpoint or model is needed; the op library is
    imported here. A program traced for the card raises where no card is
    present."""
    from .ops import library  # noqa: F401  (registers the custom ops)

    with open(path, "rb") as fh:
        meta, archive = _unseal(fh.read(), path)
    kind, archive, meta = _program_for(meta, archive, path, device)
    own = resolve_device(kind)
    program = torch.export.load(io.BytesIO(archive)).module()
    bf16 = meta["dtype"] == "bf16"

    def fn(pc_batch):
        if isinstance(pc_batch, torch.Tensor):
            x = pc_batch.to(own, torch.float32)
        else:
            x = torch.as_tensor(np.asarray(pc_batch, np.float32), device=own)
        with torch.inference_mode():
            if not bf16:
                return program(x)
            # the live bf16 forward's products sum in f32 (models.maskplanner)
            with f32_accumulation():
                return program(x)

    fn.meta = meta
    return fn
