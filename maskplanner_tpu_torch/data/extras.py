"""Optional dataset extras: stroke prototypes, per-stroke vectors,
autoregressive history batches.

Reference: utils/dataset/paintnet_ODv1.py:360-657 (``load_extra_data``
items) and utils/dataset/paintnet_ODv1.py:950-978
(``get_vectors_per_stroke``). Static-shape variants: per-stroke lists
become −100-padded arrays over a ``max_n_strokes`` axis with validity
masks, so the rollout/strokewise loss paths stay jit-compatible.
"""
from __future__ import annotations

import numpy as np

from .pointcloud import get_3dbbox


def get_vectors_per_stroke(traj, stroke_ids):
    """Split (N, D) rows into per-stroke lists (reference :950-978).

    Returns (list of (Ni, D) arrays, stroke order array)."""
    out, order = [], []
    for sid in np.unique(stroke_ids):
        if sid == -1:
            continue
        out.append(traj[stroke_ids == sid].copy())
        order.append(int(sid))
    return out, np.array(order, dtype=int)


def pad_vectors_per_stroke(per_stroke, max_n_strokes, max_len=None,
                           pad_value=-100.0):
    """Per-stroke list -> (max_n_strokes, max_len, D) + (max_n_strokes,) mask."""
    if max_len is None:
        max_len = max(s.shape[0] for s in per_stroke)
    D = per_stroke[0].shape[-1]
    out = np.full((max_n_strokes, max_len, D), pad_value, np.float32)
    mask = np.zeros((max_n_strokes,), bool)
    for i, s in enumerate(per_stroke[:max_n_strokes]):
        # truncate strokes past the configured static budget (a stroke
        # longer than out_points_per_stroke would otherwise fail the
        # broadcast into the fixed slot)
        n = min(s.shape[0], max_len)
        out[i, :n] = s[:n]
        mask[i] = True
    return out, mask


def stroke_encoding(stroke, kind, outdim, start_of_path_token_length=4):
    """Single-stroke prototype encoding (reference :617-657)."""
    if kind == "3d_bboxes":
        bbox = get_3dbbox(stroke)  # [xmin,ymin,zmin, xmax,ymax,zmax]
        lo, hi = bbox[:3], bbox[3:]
        center = (lo + hi) / 2.0
        sizes = np.sqrt(np.maximum(hi - lo, 0.0))
        return np.concatenate([center, sizes])
    if kind == "start_of_path_token":
        assert stroke.shape[-1] == outdim, "stroke must be in point format"
        n = start_of_path_token_length
        if stroke.shape[0] < n:
            assert n % 2 == 0 and stroke.shape[0] >= n // 2, (
                f"stroke too short ({stroke.shape[0]}) for prototype length {n}")
            pts = stroke[: n // 2]
            pts = np.repeat(pts[None], 2, axis=0).reshape(-1, outdim)
        else:
            pts = stroke[:n]
        return pts.reshape(-1)
    raise ValueError(f"invalid stroke prototype kind: {kind}")


def get_stroke_prototypes(traj_as_pc, stroke_ids_as_pc, kind, outdim,
                          start_of_path_token_length=4):
    """All-stroke prototype encodings (reference :584-615)."""
    protos, order = [], []
    for sid in np.unique(stroke_ids_as_pc):
        if sid == -1:
            continue
        stroke = traj_as_pc[stroke_ids_as_pc == sid]
        protos.append(stroke_encoding(stroke, kind, outdim,
                                      start_of_path_token_length))
        order.append(int(sid))
    return np.stack(protos), np.array(order, dtype=int)


def pad_prototypes(protos, max_n_strokes, pad_value=-100.0):
    out = np.full((max_n_strokes, protos.shape[-1]), pad_value, np.float32)
    out[: protos.shape[0]] = protos
    return out


def history_batches_v1(segments_per_stroke, history_length_plus_one,
                       rng: np.random.Generator):
    """One random history window per stroke (reference :491-525)."""
    subs, inits = [], []
    for stroke in segments_per_stroke:
        L, D = stroke.shape
        assert L > history_length_plus_one, (
            f"stroke ({L}) shorter than history {history_length_plus_one}")
        end = int(rng.integers(0, L))
        start = end + 1 - history_length_plus_one
        if start >= 0:
            sub = stroke[start : end + 1].copy()
        else:
            valid = stroke[: end + 1]
            sub = np.concatenate(
                [np.zeros((-start, D)), valid], axis=0)
        subs.append(sub)
        init = np.concatenate(
            [np.zeros((history_length_plus_one - 1, D)), stroke[:1]], axis=0)
        inits.append(init)
    return subs, inits


def history_batches_v2(segments_per_stroke, path_ids, K):
    """All possible K-length histories of all strokes (reference :528-581).

    Returns (histories (T,K,D), targets (T,D), path ids (T,), eop (T,))."""
    hist, tgt, pid, eop = [], [], [], []
    for path, path_id in zip(segments_per_stroke, path_ids):
        N, D = path.shape
        for i in range(N):
            h = np.zeros((K, D))
            start = max(0, i - K)
            if start < i:
                h[-(i - start):] = path[start:i]
            hist.append(h)
            tgt.append(path[i])
            pid.append(path_id)
            eop.append(i == N - 1)
    return (np.asarray(hist), np.asarray(tgt), np.asarray(pid),
            np.asarray(eop))


def add_history_noise(history_batch, lambda_points, outdim, trasl_stdev,
                      orient_stdev, weight_orient,
                      rng: np.random.Generator):
    """Noisy teacher forcing for autoregressive_v2 (reference :429-448).

    NOTE (reference parity): like the reference, noise + orientation
    renormalization apply to every history row including the all-zero
    pre-start padding rows — the reference renormalizes them identically
    (and would divide by 0 where we clamp to 1e-12).
    """
    K = history_batch.shape[1]
    h = history_batch.reshape(history_batch.shape[0], K, lambda_points, outdim)
    noise = np.concatenate([
        rng.normal(0, trasl_stdev, size=h[..., :3].shape),
        rng.normal(0, orient_stdev, size=h[..., 3:].shape),
    ], axis=-1)
    h = h + noise
    norms = np.linalg.norm(h[..., 3:], axis=-1, keepdims=True)
    h[..., 3:] = h[..., 3:] / np.maximum(norms, 1e-12) * weight_orient
    return h.reshape(history_batch.shape[0], K, -1)
