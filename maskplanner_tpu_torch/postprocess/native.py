"""ctypes bindings for the native host kernels (native/ocmg_native.cpp).

Lazy-loads ``native/libocmg_native.so`` (built by ``make -C native``; an
automatic build is attempted on first use). All callers fall back to the
pure-Python implementations when the library is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libocmg_native.so")
_lib = None
_tried = False


def _rebuild() -> bool:
    try:
        subprocess.run(["make", "-B", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.isfile(_LIB_PATH) and not _rebuild():
        return None
    for attempt in range(2):
        try:
            _lib = _bind(ctypes.CDLL(_LIB_PATH))
            return _lib
        except (OSError, AttributeError):
            # stale .so missing newer symbols -> rebuild once
            if attempt == 0 and _rebuild():
                continue
            _lib = None
            return None


def _bind(lib):
    lib.chu_liu_edmonds_path.restype = ctypes.c_int
    lib.chu_liu_edmonds_path.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int)]
    lib.solve_lap.restype = None
    lib.solve_lap.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.greedy_spaced_select.restype = ctypes.c_int
    lib.greedy_spaced_select.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int)]
    lib.filter_near_duplicates.restype = ctypes.c_int
    lib.filter_near_duplicates.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.akima_eval.restype = ctypes.c_int
    lib.akima_eval.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double)]
    lib.trim_overlap_keep.restype = ctypes.c_int
    lib.trim_overlap_keep.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int)]
    lib.resample_upsample_smooth.restype = ctypes.c_int
    lib.resample_upsample_smooth.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    lib.concat_order.restype = ctypes.c_int
    lib.concat_order.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.filter_segments_item.restype = None
    lib.filter_segments_item.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    lib.process_strokes_item.restype = ctypes.c_longlong
    lib.process_strokes_item.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong]
    return lib


def available() -> bool:
    return _load() is not None


def edmonds_longest_path(d2: np.ndarray, big: float) -> list[int] | None:
    """Min spanning arborescence (virtual root) + longest path over a dense
    directed cost matrix. Returns node order or None if unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    n = d2.shape[0]
    d2 = np.ascontiguousarray(d2, dtype=np.float64)
    out = np.zeros(n, dtype=np.int32)
    length = lib.chu_liu_edmonds_path(
        d2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        ctypes.c_double(big),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if length <= 0:
        return None
    return out[:length].tolist()


def greedy_spaced_select(pts: np.ndarray, distance: float) -> np.ndarray | None:
    """Indices of the greedy equal-spacing walk (first row always kept);
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n, d = pts.shape
    out = np.zeros(max(n, 1), dtype=np.int32)
    count = lib.greedy_spaced_select(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, d,
        ctypes.c_double(distance),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out[:count].astype(np.int64)


def filter_near_duplicates(rows: np.ndarray, threshold: float,
                           max_removed: int) -> np.ndarray | None:
    """Indices removed by the greedy nearest-duplicate suppression;
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    n, d = rows.shape
    out = np.zeros(max(n, 1), dtype=np.int32)
    count = lib.filter_near_duplicates(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, d,
        ctypes.c_double(threshold), int(max_removed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out[:count].astype(np.int64)


def akima_eval(y: np.ndarray, ts: np.ndarray) -> np.ndarray | None:
    """Akima interpolation of ``y`` (N, D) over uniform x=0..N-1 at query
    times ``ts``; out-of-range rows are dropped (scipy extrapolate=False
    semantics). None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, dtype=np.float64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    n, d = y.shape
    out = np.empty((ts.shape[0], d), dtype=np.float64)
    cnt = lib.akima_eval(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, d,
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ts.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out[:cnt]


def trim_overlap_keep(stroke: np.ndarray, lam: int, outdim: int,
                      dist: float) -> np.ndarray | None:
    """Kept flat pose indices after adjacent-segment overlap trimming;
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    stroke = np.ascontiguousarray(stroke, dtype=np.float64)
    n_seg = stroke.shape[0]
    out = np.empty(n_seg * lam, dtype=np.int32)
    cnt = lib.trim_overlap_keep(
        stroke.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_seg, int(lam), int(outdim), ctypes.c_double(dist),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out[:cnt].astype(np.int64)


def resample_upsample_smooth(points: np.ndarray, resample_dist: float,
                             do_interp: bool) -> np.ndarray | None:
    """Fused per-stroke tail (equal-space resample [+ 5x Akima upsample +
    sigma=2 Gaussian]); None if the native library is unavailable or the
    pose dimension exceeds the kernel's row buffer."""
    lib = _load()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    n, d = points.shape
    if d > 64:  # C kernel's fixed row buffer
        return None
    cap = (10 * n + 2) * (5 if do_interp else 1) + 8
    out = np.empty((cap, d), dtype=np.float64)
    cnt = lib.resample_upsample_smooth(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, d,
        ctypes.c_double(resample_dist), int(bool(do_interp)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out[:cnt].copy()


def concat_order(traj: np.ndarray, lam: int, outdim: int, radius: float,
                 k: int) -> list[int] | None:
    """Whole-stroke concat ordering (endpoint features + kNN digraph +
    Edmonds + longest path) in one native call. None if unavailable or the
    native solve failed (caller falls back to the Python graph build)."""
    lib = _load()
    if lib is None:
        return None
    traj = np.ascontiguousarray(traj, dtype=np.float64)
    n_seg = traj.shape[0]
    out = np.empty(max(n_seg, 1), dtype=np.int32)
    cnt = lib.concat_order(
        traj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_seg, int(lam), int(outdim), ctypes.c_double(radius), int(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if cnt <= 0:
        return None
    return out[:cnt].tolist()


def filter_segments_item(traj: np.ndarray, ids: np.ndarray,
                         percentage: float, threshold: float) -> bool:
    """In-place per-item near-duplicate segment suppression across all
    strokes (removed rows -> -100 / id -1). Returns False if the native
    library is unavailable (caller falls back to the per-stroke path)."""
    lib = _load()
    if lib is None:
        return False
    assert traj.flags.c_contiguous and traj.dtype == np.float64
    assert ids.flags.c_contiguous and ids.dtype == np.int64
    S, D = traj.shape
    lib.filter_segments_item(
        traj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        S, D, ctypes.c_double(percentage), ctypes.c_double(threshold))
    return True


def process_strokes_item(traj: np.ndarray, ids: np.ndarray, lam: int,
                         outdim: int, knn: int, radius: float,
                         trim_dist: float, resample_dist: float,
                         do_interp: bool):
    """Whole-item per-stroke postprocess tail in ONE native call: group by
    stroke id, Edmonds concat ordering, adjacent-segment overlap trim,
    equal-space resample [+ 5x Akima upsample + Gaussian smoothing].
    Returns (points (N, outdim), pose stroke ids (N,)) or None if the
    native library is unavailable / the solve bailed (caller falls back
    to the per-stroke Python loop)."""
    lib = _load()
    if lib is None or outdim > 64:
        return None
    traj = np.ascontiguousarray(traj, dtype=np.float64)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    S = traj.shape[0]
    n_strokes = max(int((np.unique(ids) >= 0).sum()), 1)
    cap = ((10 * S * lam + 2 * n_strokes) * 5 + 64) * outdim
    out = np.empty(cap, dtype=np.float64)
    out_ids = np.empty(cap // outdim, dtype=np.float64)
    total = lib.process_strokes_item(
        traj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        S, int(lam), int(outdim), int(knn), ctypes.c_double(radius),
        ctypes.c_double(trim_dist), ctypes.c_double(resample_dist),
        int(bool(do_interp)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_longlong(cap))
    if total < 0:
        return None
    n = int(total)
    return out[: n * outdim].reshape(n, outdim).copy(), out_ids[:n].copy()


def solve_lap(cost: np.ndarray) -> np.ndarray | None:
    """JV LAP: returns row4col (n_cols,) or None if unavailable.

    Requires n_rows >= n_cols (the C++ kernel pads rows, not columns);
    returns None otherwise so callers fall back to scipy.
    """
    lib = _load()
    if lib is None:
        return None
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n_rows, n_cols = cost.shape
    if n_rows < n_cols:
        return None
    out = np.zeros(n_cols, dtype=np.int32)
    lib.solve_lap(cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  n_rows, n_cols,
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out.astype(np.int64)
