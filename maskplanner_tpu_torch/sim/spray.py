"""Geometric spray-deposition simulator (proprietary-simulator stand-in).

The port's copy of ``maskplanner_tpu/sim/spray.py`` (numpy only, run on the
host in both packages): the same functions on the same inputs give the
same bits (``tests/test_torch_port_coverage.py``).

The reference's ">99% paint coverage" metric (reference ``README.md:10``,
``standalone/compute_paint_coverage_per_face.py:62-114``) depends on a
proprietary EFORT spray simulator that turns robot programs into per-face
paint-thickness CSVs (SURVEY §3.5: the external boundary). That simulator
is not available, so the loop could never be closed in-repo. This module
is an open, geometry-only deposition model with the same I/O contract:

    programs (X;Y;Z;A;B;C;strokeId  CSVs, workspace scale)
        + mesh OBJ
        -> per-face-vertex thickness CSVs (3 rows per face)
        -> standalone/compute_paint_coverage_per_face.py

Deposition model. Each trajectory pose is a spray-gun pose: position
``p`` and spray axis ``d`` (the pose's orientation normal, pointing at
the surface — the convention of the dataset trajectories, reference
``utils/disk.py:184-220`` ``orientnorm`` = rotated e1). Paint flux from
pose (p, d) onto surface point ``q`` with outward face normal ``n``:

    theta  = angle(d, q - p)                  # off-axis beam angle
    r      = |q - p|
    flux   = exp(-theta^2 / (2 sigma^2))      # Gaussian beam profile
             * (r0 / r)^2                     # inverse-square falloff
             * max(0, -(q-p)/r . n)           # Lambertian incidence
             * [theta <= cone_cutoff]         # hard cone edge

Thickness at q = sum of flux over all poses. There is no occlusion or
shadowing (stand-in limitation; the PaintNet categories are box-like and
painted face-by-face, so self-shadowing is marginal). The absolute scale
of the thickness is arbitrary — the coverage metric thresholds on the
GT's own percentile, so only relative thickness matters.
"""
from __future__ import annotations

import os

import numpy as np

DEFAULT_SIGMA_DEG = 12.0
DEFAULT_CONE_DEG = 30.0


def surface_centroid(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted surface centroid of a triangle mesh.

    Matches the expectation of the loader's mesh-centroid centering
    (mean of uniform surface samples, reference
    ``utils/pointcloud.py:30-37`` ``center_pair``) deterministically.
    """
    tri = verts[faces]  # (F, 3, 3)
    centers = tri.mean(axis=1)
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    total = areas.sum()
    if total <= 0:
        return verts.mean(axis=0)
    return (areas[:, None] * centers).sum(axis=0) / total


def _face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def pose_arclength_weights(positions: np.ndarray,
                           stroke_ids: np.ndarray | None,
                           cap_factor: float = 3.0) -> np.ndarray:
    """Per-pose dwell weights proportional to local arc length.

    A constant-speed spray gun deposits paint per unit PATH LENGTH, not
    per program waypoint — per-pose summation makes the measured
    thickness scale with waypoint density, so a postprocess that
    resamples/upsamples a stroke (reference utils/postprocessing.py
    resample + Akima 5x) would inflate its own paint mass ~6x (measured,
    docs/floor_rootcause.md round-5 integrity check). Weight = half the
    distance to each in-stroke neighbour (trapezoidal dwell), capped at
    ``cap_factor``x the program's median spacing so inter-pass gaps
    inside a stroke cannot deposit a gap's worth of paint at one pose.
    """
    P = positions.shape[0]
    if P == 0:
        return np.zeros(0)
    if stroke_ids is None:
        stroke_ids = np.zeros(P)
    w = np.zeros(P)
    all_ds = []
    for sid in np.unique(stroke_ids):
        idx = np.where(stroke_ids == sid)[0]
        if idx.size == 1:
            continue
        ds = np.linalg.norm(np.diff(positions[idx], axis=0), axis=-1)
        all_ds.append(ds)
        w[idx[:-1]] += 0.5 * ds
        w[idx[1:]] += 0.5 * ds
    if not all_ds:
        return np.ones(P)
    med = float(np.median(np.concatenate(all_ds)))
    if med <= 0:
        med = float(np.mean(np.concatenate(all_ds))) or 1.0
    np.clip(w, None, cap_factor * med, out=w)
    w[w == 0] = med  # isolated single-pose strokes get one median dwell
    return w / med   # ~1 at the program's own median spacing


def simulate_spray(points: np.ndarray, normals: np.ndarray,
                   positions: np.ndarray, dirs: np.ndarray, *,
                   sigma_deg: float = DEFAULT_SIGMA_DEG,
                   cone_deg: float = DEFAULT_CONE_DEG,
                   r0: float | None = None,
                   pose_weights: np.ndarray | None = None,
                   chunk: int = 4096) -> np.ndarray:
    """Accumulated paint thickness at ``points`` from all gun poses.

    Parameters
    ----------
    points    : (M, 3) surface sample positions
    normals   : (M, 3) outward surface normals at those points
    positions : (P, 3) gun positions
    dirs      : (P, 3) spray axes (normalized internally; toward surface)
    r0        : reference standoff for the inverse-square term; default =
                median gun-to-nearest-surface-point distance, so flux ~= 1
                at the program's own standoff
    pose_weights : optional (P,) per-pose dwell weights (see
                ``pose_arclength_weights``); None = 1 per pose
    chunk     : surface points per vectorized (P x chunk) block
    """
    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    positions = np.asarray(positions, np.float64)
    dirs = np.asarray(dirs, np.float64)
    dirs = dirs / np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True),
                             1e-12)
    if positions.shape[0] == 0:
        return np.zeros(points.shape[0])

    sigma = np.deg2rad(sigma_deg)
    cone = np.deg2rad(cone_deg)

    if r0 is None:
        # median standoff over a subsample (full pairwise is P x M)
        sub = points[:: max(1, points.shape[0] // 1024)]
        d2 = ((positions[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
        r0 = float(np.median(np.sqrt(d2.min(axis=1))))
        r0 = max(r0, 1e-9)

    if pose_weights is not None:
        pose_weights = np.asarray(pose_weights, np.float64)
        assert pose_weights.shape == (positions.shape[0],)

    out = np.zeros(points.shape[0])
    for s in range(0, points.shape[0], chunk):
        q = points[s:s + chunk]          # (m, 3)
        n = normals[s:s + chunk]         # (m, 3)
        rel = q[None, :, :] - positions[:, None, :]        # (P, m, 3)
        r = np.maximum(np.linalg.norm(rel, axis=-1), 1e-9)  # (P, m)
        u = rel / r[..., None]
        cos_theta = np.clip((u * dirs[:, None, :]).sum(-1), -1.0, 1.0)
        theta = np.arccos(cos_theta)
        incidence = np.maximum(0.0, -(u * n[None, :, :]).sum(-1))
        flux = (np.exp(-0.5 * (theta / sigma) ** 2)
                * (r0 / r) ** 2 * incidence)
        flux[theta > cone] = 0.0
        if pose_weights is not None:
            flux *= pose_weights[:, None]
        out[s:s + chunk] = flux.sum(axis=0)
    return out


def facevertex_thickness(verts: np.ndarray, faces: np.ndarray,
                         positions: np.ndarray, dirs: np.ndarray,
                         **kw) -> np.ndarray:
    """Thickness at each face corner (3 rows per face, the simulator CSV
    contract of reference ``compute_paint_coverage_per_face.py:141-176``).

    Corners are evaluated with their face's normal, so the per-face mean
    taken by the coverage tool averages three samples of the same face.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    corners = verts[faces].reshape(-1, 3)                    # (3F, 3)
    normals = np.repeat(_face_normals(verts, faces), 3, axis=0)
    return simulate_spray(corners, normals, positions, dirs, **kw)


def write_thickness_csv(path: str, values: np.ndarray) -> None:
    """``index;thickness`` rows, one per face-vertex (3 per face)."""
    with open(path, "w", encoding="utf-8") as f:
        for i, v in enumerate(np.asarray(values, np.float64)):
            print(f"{i};{v}", file=f)


def _auto_sign(positions: np.ndarray, dirs: np.ndarray,
               centroid: np.ndarray) -> float:
    """+1 if the spray axes mostly point at the object, else -1.

    Guards against the opposite orientation convention (outward surface
    normals instead of inward spray axes) in externally produced
    programs.
    """
    to_obj = centroid[None, :] - positions
    to_obj = to_obj / np.maximum(
        np.linalg.norm(to_obj, axis=-1, keepdims=True), 1e-12)
    mean_dot = float((dirs * to_obj).sum(-1).mean())
    return 1.0 if mean_dot >= 0.0 else -1.0


def simulate_program(mesh_path: str, program_path: str,
                     out_path: str | None = None, *,
                     center: bool = True, per_arclength: bool = False,
                     **kw) -> np.ndarray:
    """Mesh OBJ + robot program -> per-face-vertex thickness (3F,).

    The exported programs live in a frame centered on the object
    (``from_pred_to_offline_v2`` exports around the origin); with
    ``center=True`` the mesh is shifted by its vertex centroid — the
    loader's centering convention (reference ``center_pair`` ->
    ``get_mean_mesh``, utils/pointcloud.py:24-37) — to match. Writes the
    CSV when ``out_path`` is given.

    ``per_arclength=True`` weights each pose's flux by its local dwell
    (``pose_arclength_weights``): a constant-speed gun model that makes
    the measured thickness invariant to waypoint density — the default
    per-pose summation lets a resampling postprocess change its own
    paint mass (round-5 integrity check, docs/floor_rootcause.md).
    """
    from ..data.io import load_obj, read_traj_file

    verts, faces = load_obj(mesh_path)
    if faces.size == 0:
        raise ValueError(f"{mesh_path}: mesh has no faces")
    if center:
        verts = verts - verts.mean(axis=0)

    traj, prog_ids = read_traj_file(program_path,
                                    extra_data=("orientnorm",))
    positions, dirs = traj[:, :3], traj[:, 3:6]
    if per_arclength:
        kw = dict(kw)
        kw["pose_weights"] = pose_arclength_weights(positions, prog_ids)
    dirs = dirs * _auto_sign(
        positions, dirs / np.maximum(
            np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12),
        surface_centroid(verts, faces))

    thickness = facevertex_thickness(verts, faces, positions, dirs, **kw)
    if out_path is not None:
        write_thickness_csv(out_path, thickness)
    return thickness
