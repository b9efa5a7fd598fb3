"""Segment filtering, concatenation and smoothing pipeline.

Reference: ``utils/postprocessing.py:155-432`` (process_stroke_segments +
helpers). Turns per-segment predictions with stroke ids into smooth,
ordered, executable per-stroke trajectories:

1. per-stroke greedy filtering of near-duplicate segments
2. per-stroke ordering via Edmonds arborescence (``concat``)
3. removal of poses overlapping between adjacent segments
4. equal-space resampling -> Akima 5× upsample -> Gaussian smoothing
"""
from __future__ import annotations

import numpy as np

from ..data.pointcloud import from_seq_to_pc, get_dim_traj_points
from .concat import concat_segments_of_stroke

FILTER_SEGMENTS_PERCENTAGE = 1.0
FILTER_DISTANCE_THRESHOLD = 0.1


def filter_overlapping_segments(traj: np.ndarray, stroke_ids: np.ndarray,
                                percentage: float = FILTER_SEGMENTS_PERCENTAGE,
                                threshold: float = FILTER_DISTANCE_THRESHOLD):
    """Greedy per-stroke duplicate-segment suppression
    (reference utils/postprocessing.py:189-235): repeatedly remove the
    segment whose nearest neighbour within the stroke is closest, until the
    budget is reached or no pair is closer than ``threshold``. Removed rows
    become −100 / id −1."""
    from . import native

    out_traj = np.ascontiguousarray(traj, np.float64)
    if out_traj is traj:
        out_traj = traj.copy()
    out_ids = np.ascontiguousarray(stroke_ids, np.int64)
    if out_ids is stroke_ids:
        out_ids = stroke_ids.copy()
    if native.available():
        # whole-item native pass (grouping + per-stroke greedy suppression)
        for b in range(out_traj.shape[0]):
            native.filter_segments_item(out_traj[b], out_ids[b],
                                        percentage, threshold)
        return out_traj, out_ids

    for b in range(traj.shape[0]):
        for sid in np.unique(stroke_ids[b]):
            if sid == -1:
                continue
            sel = stroke_ids[b] == sid
            stroke = traj[b][sel].copy()
            ids = stroke_ids[b][sel].copy()
            n = stroke.shape[0]
            if n <= 1.0 / percentage:
                continue
            to_filter = int(n * percentage)
            removed_idx = native.filter_near_duplicates(
                stroke, threshold, to_filter)
            if removed_idx is None:
                # pure-python fallback: O(n^3) recompute loop (reference
                # utils/postprocessing.py:189-235 verbatim behavior)
                removed: list[int] = []
                alive = stroke.copy()
                while len(removed) < to_filter:
                    d = np.linalg.norm(
                        alive[:, None, :] - alive[None, :, :], axis=-1)
                    np.fill_diagonal(d, np.inf)
                    nn = d.min(axis=1)
                    nn[removed] = np.inf
                    if (np.all(nn[np.isfinite(nn)] > threshold)
                            or not np.isfinite(nn).any()):
                        break
                    idx = int(np.argmin(nn))
                    alive[idx] = -100.0  # push out of NN range
                    removed.append(idx)
                removed_idx = np.asarray(removed, dtype=np.int64)
            stroke[removed_idx] = -100.0
            ids[removed_idx] = -1
            out_traj[b][sel] = stroke
            out_ids[b][sel] = ids
    return out_traj, out_ids


def find_non_overlapping_points_among_adjacent_segments(stroke, distance,
                                                        outdim):
    """Indices of poses to keep after trimming each segment's tail where it
    runs into the next segment's start
    (reference utils/postprocessing.py:350-391)."""
    from . import native

    N, D = stroke.shape
    lam = D // outdim
    keep = native.trim_overlap_keep(stroke, lam, outdim, distance)
    if keep is not None:
        return keep
    keep = []
    for i in range(N - 1):
        cur = stroke[i].reshape(lam, outdim)
        nxt_start = stroke[i + 1].reshape(lam, outdim)[0]
        cut = lam
        for j in range(lam):
            if np.linalg.norm(cur[j] - nxt_start) < distance:
                cut = j + 1
                break
        keep += (np.arange(cut) + lam * i).tolist()
    keep += (np.arange(lam) + lam * (N - 1)).tolist()
    return keep


def resample_at_equal_spaced_points_except_last(stroke, distance):
    """Akima-walk resampling keeping the final pose
    (reference utils/postprocessing.py:396-432).

    The reference steps t by 0.1 calling the interpolator one point at a
    time (one scipy dispatch per step — the postprocess hot spot). Here the
    curve is evaluated for all t in one vectorized call and the greedy
    keep-if-farther-than-``distance`` walk runs in native C++ (numpy-loop
    fallback)."""
    from scipy.interpolate import Akima1DInterpolator

    from . import native

    N = stroke.shape[0]
    if N < 3:
        return stroke.copy()
    curve = Akima1DInterpolator(np.arange(N), stroke)
    # replicate the reference's accumulated-float t grid bit for bit
    # (postprocessing.py:413-429: curr_t += 0.1 repeatedly, compared
    # against times[-1] + 0.0005) — a closed-form grid can differ by one
    # razor-edge step and desynchronize the greedy walk
    ts, t = [], 0.1
    while t <= N - 1 + 0.0005:
        ts.append(t)
        t += 0.1
    pts = np.concatenate([stroke[:1], curve(np.asarray(ts))], axis=0)

    keep = native.greedy_spaced_select(pts, distance)
    if keep is None:  # pure-python fallback (same walk, precomputed points)
        keep = [0]
        last = pts[0]
        for i in range(1, pts.shape[0]):
            if float(np.linalg.norm(pts[i] - last)) > distance:
                keep.append(i)
                last = pts[i]
        keep = np.asarray(keep)
    return np.concatenate([pts[keep], stroke[-1:]], axis=0)


def apply_filter_to_each_dim(signal, kind="gaussian", **kwargs):
    """Per-dimension 1-D filtering (reference utils/postprocessing.py:327-347)."""
    if kind == "gaussian":
        from scipy.ndimage import gaussian_filter1d

        # gaussian_filter1d is separable along axis 0 directly — one call
        # filters all dims (identical output to the per-dim loop)
        return gaussian_filter1d(signal, axis=0, **kwargs)
    if kind == "median":
        from scipy.signal import medfilt

        out = signal.copy()
        w = kwargs["window"]
        for d in range(signal.shape[-1]):
            out[w // 2 : -(w // 2), d] = medfilt(out[w // 2 : -(w // 2), d], w)
        return out
    raise ValueError(kind)


def split_offpath_strokes(rows: np.ndarray, ids: np.ndarray, config):
    """Re-id a stroke's off-path segments as new sub-strokes until every
    stroke is a complete Edmonds path (round-5 coverage fix).

    The reference's concat executes only the longest path of each
    stroke's segment arborescence and silently DROPS the rest
    (utils/cluster.py:83-89). Root-causing the per-category coverage
    floors (docs/floor_rootcause.md) showed those dropped segments are
    the dominant failure: floor items score 94-100% from the raw export
    but 73-89% postprocessed, with the loss isolated to the concat stage.
    This pass keeps the reference's ordering while painting ALL predicted
    segments: leftovers become fresh stroke ids and are re-ordered
    recursively (each leftover group is strictly smaller — terminates).
    """
    from .concat import order_path_indices

    ids = np.asarray(ids, np.int64).copy()
    next_id = int(ids.max()) + 1 if (ids >= 0).any() else 0
    work = [int(s) for s in np.unique(ids) if s >= 0]
    while work:
        sid = work.pop()
        sel = np.where((ids == sid) & ~np.all(rows == -100.0, -1))[0]
        if sel.size <= 1:
            continue
        path = order_path_indices(np.asarray(rows[sel], np.float64), config)
        if len(path) < sel.size:
            leftovers = np.setdiff1d(sel, sel[path])
            ids[leftovers] = next_id
            work.append(next_id)
            next_id += 1
    return ids


def process_stroke_segments(traj, stroke_ids, config,
                            skip_segments_filtering=False,
                            segments_filtering_only=False,
                            no_interpolation=False,
                            fast_concat=False,
                            cover_all=False,
                            verbose=0):
    """Full postprocess (reference utils/postprocessing.py:155-324).

    traj: (B, S, λ·outdim) predicted segments; stroke_ids: (B, S) from the
    mask postprocess. Returns (list of (N_b, outdim) trajectories, list of
    (N_b,) stroke ids) per batch element.

    ``cover_all=True`` splits each stroke's off-Edmonds-path segments
    into sub-strokes instead of dropping them (``split_offpath_strokes``)
    — the round-5 coverage fix; False preserves the reference's
    drop-off-path behavior (utils/cluster.py:83-89) for parity.
    """
    outdim = get_dim_traj_points(config["extra_data"])
    if not skip_segments_filtering:
        traj, stroke_ids = filter_overlapping_segments(
            np.asarray(traj), np.asarray(stroke_ids))
    if segments_filtering_only:
        return traj, stroke_ids
    if cover_all:
        traj = np.asarray(traj)
        stroke_ids = np.stack([
            split_offpath_strokes(traj[b], np.asarray(stroke_ids)[b], config)
            for b in range(traj.shape[0])])

    esd = config.get("equal_spaced_points_distance") or 0.05
    out_trajs, out_ids = [], []

    # whole-item fused native path: one C++ call per batch element runs
    # the entire per-stroke tail (concat order + overlap trim + resample/
    # upsample/smooth) — eliminates ~20 Python/ctypes round-trips per
    # stroke, the residual cost after the kernels themselves went native
    if not fast_concat and not verbose:
        from . import native
        from .concat import KNN, RADIUS

        fused_ok = True
        for b in range(traj.shape[0]):
            res = native.process_strokes_item(
                np.asarray(traj[b], np.float64),
                np.asarray(stroke_ids[b], np.int64),
                lam=int(config["lambda_points"]), outdim=outdim,
                knn=KNN, radius=RADIUS, trim_dist=0.05,
                resample_dist=esd if no_interpolation else 0.1,
                do_interp=not no_interpolation)
            if res is None:
                fused_ok = False
                out_trajs, out_ids = [], []
                break
            out_trajs.append(res[0])
            out_ids.append(res[1])
        if fused_ok:
            return out_trajs, out_ids

    for b in range(traj.shape[0]):
        parts: list[np.ndarray] = []
        part_ids: list[np.ndarray] = []
        for sid in np.unique(stroke_ids[b]):
            if sid == -1:
                continue
            stroke = traj[b][stroke_ids[b] == sid]
            stroke = stroke[~np.all(stroke == -100.0, axis=-1)]
            if stroke.shape[0] == 0:
                continue
            stroke = concat_segments_of_stroke(
                stroke, None, config, verbose=verbose)

            keep = find_non_overlapping_points_among_adjacent_segments(
                stroke, distance=0.05, outdim=outdim)
            points = from_seq_to_pc(stroke, extra_data=config["extra_data"])
            points = points[keep]

            if not fast_concat:
                # fused native tail: Akima resample walk [+ 5x upsample +
                # Gaussian] in one C++ call per stroke — the scipy
                # Akima1DInterpolator constructions here were the
                # postprocess hot spot (~0.6 ms each, 2 per stroke)
                from . import native

                fused = native.resample_upsample_smooth(
                    points, esd if no_interpolation else 0.1,
                    do_interp=not no_interpolation)
                if fused is not None:
                    points = fused
                elif no_interpolation:
                    points = resample_at_equal_spaced_points_except_last(
                        points, distance=esd)
                else:
                    points = resample_at_equal_spaced_points_except_last(
                        points, distance=0.1)
                    if points.shape[0] >= 3:
                        from scipy.interpolate import Akima1DInterpolator

                        curve = Akima1DInterpolator(
                            np.arange(points.shape[0]), points)
                        ts = np.arange(0, points.shape[0], step=1 / 5)
                        points = curve(ts)
                        points = points[~np.isnan(points[:, 0])]
                        points = apply_filter_to_each_dim(
                            points, kind="gaussian", sigma=2)

            parts.append(points)
            part_ids.append(np.repeat(sid, points.shape[0]))
        out_trajs.append(np.concatenate(parts, axis=0) if parts
                         else np.empty((0, outdim)))
        out_ids.append(np.concatenate(part_ids).astype(np.float64)
                       if part_ids else np.empty((0,)))
    return out_trajs, out_ids
