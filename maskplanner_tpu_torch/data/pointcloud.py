"""Host-side geometry preprocessing (numpy).

Re-implements the reference's trajectory/point-cloud transforms
(``utils/pointcloud.py``): pose-dimension registry, normalization,
equal-spacing resampling, λ-segment construction, padding/mask conversion
and format conversions. These run on the host during dataset
materialization (cached to .npz, reference utils/dataset/paintnet_ODv1.py:
196-243); everything downstream of the collate is static-shaped device
code.
"""
from __future__ import annotations

import numpy as np

PAD_VALUE = -100.0
PAD_STROKE_ID = -1

_ORIENT_DIMS = {"orientquat": 4, "orientrotvec": 3, "orientnorm": 3}


def orient_in(extra_data):
    """Which orientation representation (if any) is in extra_data.
    Reference: utils/__init__.py ``orient_in``."""
    for k in _ORIENT_DIMS:
        if k in extra_data:
            return True, k
    return False, None


def get_dim_traj_points(extra_data) -> int:
    """Per-pose dimensionality (reference utils/pointcloud.py:478-491)."""
    extra_data = list(extra_data or [])
    if not extra_data:
        return 3
    if extra_data == ["vel"]:
        return 6
    if extra_data == ["orientquat"]:
        return 7
    if extra_data in (["orientrotvec"], ["orientnorm"]):
        return 6
    raise ValueError(f"unsupported extra_data combination: {extra_data}")


def get_dim_orient_traj_points(extra_data) -> int:
    """Orientation dims per pose (reference utils/pointcloud.py:494-507)."""
    has_orient, kind = orient_in(extra_data or [])
    return _ORIENT_DIMS[kind] if has_orient else 0


def get_traj_feature_index(feat, extra_data):
    """Column indices of a pose feature (reference utils/pointcloud.py:428-475)."""
    if feat is None:
        return None
    extra_data = list(extra_data or [])
    table = {"pos": [0, 1, 2], "vel": None, "orientquat": None,
             "orientrotvec": None, "orientnorm": None}
    if extra_data == ["vel"]:
        table["vel"] = [3, 4, 5]
    elif extra_data == ["orientquat"]:
        table["orientquat"] = [3, 4, 5, 6]
    elif extra_data == ["orientrotvec"]:
        table["orientrotvec"] = [3, 4, 5]
    elif extra_data == ["orientnorm"]:
        table["orientnorm"] = [3, 4, 5]
    elif extra_data:
        raise ValueError(f"unsupported extra_data combination: {extra_data}")
    return table[feat]


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def normalize_pc(pc: np.ndarray) -> np.ndarray:
    """Zero-center and scale so the farthest point has norm 1
    (reference utils/pointcloud.py:76-90)."""
    pc = pc - pc.mean(axis=0)
    return pc / np.max(np.linalg.norm(pc, axis=1))


def center_pair(point_cloud, traj, centroid):
    """Shift mesh point cloud and trajectory by the mesh centroid
    (reference utils/pointcloud.py:30-37)."""
    point_cloud = point_cloud - centroid
    traj = traj.copy()
    traj[:, :3] -= centroid
    return point_cloud, traj


def denormalize_traj(traj, centroid, scale, weight_orient: float = 1.0):
    """Inverse of normalization for simulator export
    (reference utils/pointcloud.py:47-73)."""
    traj = traj.copy()
    traj[:, :3] = traj[:, :3] * scale + centroid
    if traj.shape[-1] >= 6 and weight_orient != 1.0:
        traj[:, 3:6] /= weight_orient
    return traj


# ---------------------------------------------------------------------------
# Padding <-> masks
# ---------------------------------------------------------------------------

def is_padded(traj) -> bool:
    return bool(np.any(np.all(traj[..., :3] == PAD_VALUE, axis=-1)))


def add_padding(traj, traj_points, lmbda, overlapping=0):
    """Suffix-pad segment rows with −100 up to the static segment budget
    (reference utils/pointcloud.py:98-105)."""
    if overlapping == 0:
        total = traj_points // lmbda
    else:
        total = (traj_points - lmbda) // (lmbda - overlapping) + 1
    n_fake = total - traj.shape[0]
    assert n_fake >= 0, f"segment count {traj.shape[0]} exceeds budget {total}"
    return np.pad(traj, ((0, n_fake), (0, 0)), constant_values=PAD_VALUE)


def remove_padding(traj, extra_data=()):
    """Drop suffix −100 rows (reference utils/pointcloud.py:108-114)."""
    outdim = get_dim_traj_points(extra_data)
    assert traj.shape[-1] == outdim
    pad_rows = np.all(traj[:, :3] == PAD_VALUE, axis=-1)
    if pad_rows.any():
        return traj[: np.argmax(pad_rows)].copy()
    return traj


def remove_padding_v2(traj, stroke_ids):
    """Drop fake rows anywhere (reference utils/pointcloud.py:117-128)."""
    fake = np.all(traj == PAD_VALUE, axis=-1)
    return traj[~fake].copy(), stroke_ids[~fake].copy()


def padding_to_mask(traj) -> np.ndarray:
    """Boolean validity mask from −100-padded rows (True = real)."""
    return ~np.all(traj[..., :3] == PAD_VALUE, axis=-1)


# ---------------------------------------------------------------------------
# Format conversions
# ---------------------------------------------------------------------------

def from_seq_to_pc(traj, extra_data, stroke_ids=None):
    """λ-segments -> point cloud of poses (reference utils/pointcloud.py:131-157)."""
    outdim = get_dim_traj_points(extra_data)
    if traj.shape[-1] == outdim:
        return (traj, stroke_ids) if stroke_ids is not None else traj
    lam = traj.shape[-1] // outdim
    pts = remove_padding(traj.reshape(-1, outdim), extra_data)
    if stroke_ids is not None:
        ids = np.repeat(stroke_ids[: pts.shape[0] // lam], lam)
        return pts, ids
    return pts


def from_seq_to_pc_v2(traj, stroke_ids, config):
    """As from_seq_to_pc but drops fake rows anywhere and expands ids
    (reference utils/pointcloud.py:160-180)."""
    outdim = get_dim_traj_points(config["extra_data"])
    lam = int(config["lambda_points"])
    if traj.shape[-1] == outdim:
        return traj, stroke_ids
    rows, ids = remove_padding_v2(traj, stroke_ids)
    pts = rows.reshape(-1, outdim)
    return pts, np.repeat(ids, lam)


def from_pc_to_seq(traj, traj_points, lambda_points, overlapping, extra_data,
                   padding=True):
    """Point cloud of poses -> λ-segment rows (reference utils/pointcloud.py:183-191)."""
    outdim = get_dim_traj_points(extra_data)
    assert traj.ndim == 2 and traj.shape[-1] == outdim
    seq = traj.reshape(-1, outdim * lambda_points)
    if padding:
        seq = add_padding(seq, traj_points, lambda_points, overlapping)
    return seq


def reshape_stroke_to_segments(stroke, lambda_points, overlapping):
    """Single stroke (N, D) -> (n_segments, λ, D) sliding windows
    (reference utils/pointcloud.py:416-425)."""
    if overlapping == 0:
        n = stroke.shape[0] // lambda_points * lambda_points
        return stroke[:n].reshape(-1, lambda_points, stroke.shape[-1])
    step = lambda_points - overlapping
    n_seg = (stroke.shape[0] - lambda_points) // step + 1
    idx = np.arange(n_seg)[:, None] * step + np.arange(lambda_points)[None, :]
    return stroke[idx]


# ---------------------------------------------------------------------------
# λ-segmentation
# ---------------------------------------------------------------------------

def get_sequences_of_lambda_points(traj, stroke_ids, lmbda, dirname="",
                                   overlapping=0, extra_data=(), padding=True):
    """Per-stroke sliding windows of λ consecutive poses.

    Reference: utils/pointcloud.py:294-413. Strokes shorter than λ are
    dropped (with a warning); with overlap 0 each stroke is center-cropped
    to a multiple of λ; surviving strokes are re-numbered contiguously.

    Returns (segments (M, λ·outdim), segment_stroke_ids (M,)) padded to the
    static budget when ``padding``.
    """
    outdim = get_dim_traj_points(extra_data)
    assert traj.ndim == 2 and traj.shape[-1] == outdim
    N = traj.shape[0]

    pieces, piece_ids = [], []
    skipped = 0
    new_id = 0
    for sid in np.unique(stroke_ids[stroke_ids >= 0]):
        stroke = traj[stroke_ids == sid]
        L = stroke.shape[0]
        if L < lmbda:
            skipped += 1
            continue
        if overlapping == 0:
            n_seg = L // lmbda
            off = (L % lmbda) // 2  # center crop (reference :341-343)
            windows = stroke[off : off + n_seg * lmbda].reshape(n_seg, lmbda * outdim)
        else:
            windows = reshape_stroke_to_segments(stroke, lmbda, overlapping)
            windows = windows.reshape(windows.shape[0], lmbda * outdim)
        pieces.append(windows)
        piece_ids.append(np.full(windows.shape[0], new_id, dtype=np.int64))
        new_id += 1

    assert pieces, f"all strokes shorter than lambda={lmbda} in {dirname}"
    segments = np.concatenate(pieces, axis=0)
    seg_ids = np.concatenate(piece_ids, axis=0)

    if padding:
        segments = add_padding(segments, N, lmbda, overlapping)
        seg_ids = np.concatenate(
            [seg_ids, np.full(segments.shape[0] - seg_ids.shape[0],
                              PAD_STROKE_ID, dtype=np.int64)]
        )
    if skipped:
        print(f"Warning! Skipped {skipped} strokes in {dirname} "
              f"as having length < {lmbda}")
    return segments, seg_ids


# ---------------------------------------------------------------------------
# Equal-spacing resampling (traj_sampling_v2/v3)
# ---------------------------------------------------------------------------

def resample_at_equal_spaced_points(stroke, distance, equal_in_3d_space=False):
    """Akima-interpolate a stroke and walk it with fine time steps, emitting
    a point whenever the distance to the last emitted point exceeds
    ``distance`` (reference utils/pointcloud.py:257-291)."""
    from scipy.interpolate import Akima1DInterpolator

    if equal_in_3d_space:
        raise NotImplementedError("reference raises too (pointcloud.py:265-266)")
    N = stroke.shape[0]
    curve = Akima1DInterpolator(np.arange(N), stroke)
    out = [stroke[0].copy()]
    t, dt = 0.1, 0.2
    ts = np.arange(0.1, N - 1, dt)
    samples = curve(ts)
    last = stroke[0]
    for p in samples:
        if np.linalg.norm(p - last) > distance:
            last = p
            out.append(p.copy())
    return np.asarray(out)


def subsample_at_equal_spaced_points(stroke, min_distance, equal_in_3d_space=False):
    """Greedy min-distance subsampling without interpolation
    (reference utils/pointcloud.py:231-254)."""
    out = [stroke[0].copy()]
    last = stroke[0]
    for p in stroke[1:]:
        d = (np.linalg.norm(p[:3] - last[:3]) if equal_in_3d_space
             else np.linalg.norm(p - last))
        if d > min_distance:
            last = p
            out.append(p.copy())
    return np.asarray(out)


def resample_strokes_at_equal_spaced_points(traj, stroke_ids, distance,
                                            interpolate=True,
                                            equal_in_3d_space=False):
    """Apply equal-spacing resampling per stroke
    (reference utils/pointcloud.py:194-228)."""
    outs, out_ids = [], []
    for sid in np.unique(stroke_ids):
        if sid == PAD_STROKE_ID:
            continue
        stroke = traj[stroke_ids == sid]
        if interpolate:
            res = resample_at_equal_spaced_points(stroke, distance,
                                                  equal_in_3d_space)
        else:
            res = subsample_at_equal_spaced_points(stroke, distance,
                                                   equal_in_3d_space)
        outs.append(res)
        out_ids.append(np.full(res.shape[0], sid))
    return np.concatenate(outs, axis=0), np.concatenate(out_ids, axis=0)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def get_velocities(traj, stroke_ids):
    """Per-point forward-difference velocities, zeroed at stroke ends
    (reference utils/pointcloud.py:510-521)."""
    vels = np.zeros_like(traj)
    vels[:-1] = traj[1:] - traj[:-1]
    ends = np.nonzero(np.diff(stroke_ids) != 0)[0]
    vels[ends] = 0.0
    return vels


def get_3dbbox(stroke):
    """Axis-aligned 3D bbox (min,max) encoding of a stroke
    (reference utils/pointcloud.py:552-583)."""
    lo = stroke[:, :3].min(axis=0)
    hi = stroke[:, :3].max(axis=0)
    return np.concatenate([lo, hi])


def downsample_strokes(traj, stroke_ids, n_points):
    """Uniformly subsample each stroke to n_points
    (reference utils/pointcloud.py:524-549).

    Matches the reference exactly on unpadded input: strokes with length
    <= n_points are DROPPED (no upsampling), surviving strokes are
    renumbered 0..c-1, and the outputs are stacked per stroke —
    traj (c, n_points, D), ids (c, n_points). Padding rows (id < 0, this
    repo's convention) are ignored rather than emitted as a fake stroke;
    the reference only ever sees unpadded data here."""
    outs, ids = [], []
    c = 0
    for sid in np.unique(stroke_ids):
        if sid < 0:
            continue
        stroke = traj[stroke_ids == sid]
        if stroke.shape[0] <= n_points:
            continue
        sel = np.round(np.linspace(0, stroke.shape[0] - 1,
                                   num=n_points)).astype(int)
        outs.append(stroke[sel].copy())
        ids.append(np.full(n_points, c, np.float64))
        c += 1
    return np.array(outs), np.array(ids)


def mean_knn_distance(points, k=1):
    """Mean over points of each point's mean distance to its k nearest
    neighbours (reference utils/pointcloud.py:586-623: top-(k+1) incl.
    self, drop self, clamp 1e-12, mean over the k NNs, mean over points)."""
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    knn = np.sqrt(np.sort(d2, axis=1)[:, :k])
    return float(np.maximum(knn, 1e-12).mean())


def center_traj(traj, centroid):
    """Shift only the trajectory by a mesh centroid
    (reference utils/pointcloud.py:40-45)."""
    traj[:, :3] -= centroid
    return traj


def get_center_of_3dbbox(box):
    """Center of a (min, max) bbox encoding
    (reference utils/pointcloud.py:559-561; our encoding is
    [xmin,ymin,zmin, xmax,ymax,zmax])."""
    box = np.asarray(box, dtype=np.float64)
    return 0.5 * (box[:3] + box[3:])


def get_sizes_of_3dbbox(box):
    """Per-axis extents of a (min, max) bbox encoding
    (reference utils/pointcloud.py:564-566)."""
    box = np.asarray(box, dtype=np.float64)
    return box[3:] - box[:3]


def from_bbox_encoding_to_visual_format(encoded_bbox):
    """(center, sizes) bbox encoding -> (min, max) encoding
    (reference utils/pointcloud.py:569-583)."""
    e = np.asarray(encoded_bbox, dtype=np.float64)
    center, sizes = e[:3], e[3:]
    return np.concatenate([center - sizes / 2, center + sizes / 2])
