"""Procedural synthetic OCMG data (spray-painting style).

The reference trains on the proprietary PaintNet dataset (meshes +
``trajectory.txt`` programs under ``$PAINTNET_ROOT``,
utils/disk.py:85-110). That data is not redistributable, so this module
generates structurally identical samples — a surface point cloud plus
multi-stroke 6-DoF trajectories (positions + surface normals, one raster
("boustrophedon") stroke family per face) — for tests, benchmarks and
end-to-end training runs. Category presets mirror the real categories'
statistics (strokes per object, points per stroke, object aspect).

The generator is deterministic in (category, index).
"""
from __future__ import annotations

import numpy as np

# per-category knobs: number of painted faces (strokes come in per-face
# rasters), raster passes per face, aspect jitter
CATEGORY_PRESETS = {
    "cuboids-v2": dict(n_faces=(2, 4), passes=(1, 2), size=(0.6, 1.4)),
    "windows-v2": dict(n_faces=(2, 6), passes=(1, 3), size=(0.5, 1.2)),
    "shelves-v2": dict(n_faces=(4, 10), passes=(2, 4), size=(0.6, 1.6)),
    "containers-v2": dict(n_faces=(3, 8), passes=(2, 4), size=(0.5, 1.5)),
}


def _box_face_points(rng, dims, face, n):
    """Uniform points on one face of an axis-aligned box centred at 0."""
    half = dims / 2.0
    axis, sign = face // 2, 1.0 if face % 2 == 0 else -1.0
    u_axis, v_axis = [a for a in range(3) if a != axis]
    pts = np.zeros((n, 3))
    pts[:, axis] = sign * half[axis]
    pts[:, u_axis] = rng.uniform(-half[u_axis], half[u_axis], n)
    pts[:, v_axis] = rng.uniform(-half[v_axis], half[v_axis], n)
    return pts


def _raster_stroke(rng, dims, face, n_lines, pts_per_line, standoff):
    """A boustrophedon spray path over a box face at spray standoff distance.

    Returns (traj (T,6): xyz + inward surface normal, ) one stroke.
    """
    half = dims / 2.0
    axis, sign = face // 2, 1.0 if face % 2 == 0 else -1.0
    u_axis, v_axis = [a for a in range(3) if a != axis]

    us = np.linspace(-half[u_axis] * 0.9, half[u_axis] * 0.9, n_lines)
    vs = np.linspace(-half[v_axis] * 0.9, half[v_axis] * 0.9, pts_per_line)
    rows = []
    for i, u in enumerate(us):
        v_line = vs if i % 2 == 0 else vs[::-1]
        row = np.zeros((pts_per_line, 6))
        row[:, axis] = sign * (half[axis] + standoff)
        row[:, u_axis] = u
        row[:, v_axis] = v_line
        # orientation = spray direction = inward face normal
        row[:, 3 + axis] = -sign
        rows.append(row)
    traj = np.concatenate(rows, axis=0)
    traj[:, :3] += rng.normal(0, 0.004 * dims.mean(), traj[:, :3].shape)
    return traj


def generate_sample(category: str, index: int, pc_points: int = 5120,
                    seed: int = 0):
    """One synthetic (point_cloud, traj, stroke_ids) sample.

    Returns
    -------
    point_cloud : (pc_points, 3) float32 — surface samples of the object
    traj        : (T, 6) float32 — [x,y,z,nx,ny,nz] poses, unnormalized
    stroke_ids  : (T,) int64 — contiguous per-stroke ids
    """
    import zlib

    preset = CATEGORY_PRESETS.get(category, CATEGORY_PRESETS["cuboids-v2"])
    # stable across processes (builtin hash() is PYTHONHASHSEED-randomized)
    cat_seed = zlib.crc32(category.encode())
    rng = np.random.default_rng(np.random.SeedSequence([cat_seed, index, seed]))
    dims = rng.uniform(*preset["size"], size=3)
    standoff = 0.15 * dims.mean()

    # surface point cloud over all 6 faces, area-weighted
    areas = np.empty(6)
    for f in range(6):
        a = f // 2
        u, v = [x for x in range(3) if x != a]
        areas[f] = dims[u] * dims[v]
    weights = areas / areas.sum()
    counts = rng.multinomial(pc_points, weights)
    pc = np.concatenate(
        [_box_face_points(rng, dims, f, c) for f, c in enumerate(counts) if c],
        axis=0,
    )
    if pc.shape[0] < pc_points:  # multinomial rounding
        extra = _box_face_points(rng, dims, 0, pc_points - pc.shape[0])
        pc = np.concatenate([pc, extra], axis=0)
    pc = pc[:pc_points]

    # strokes: raster passes over a few random faces
    n_faces = rng.integers(preset["n_faces"][0], preset["n_faces"][1] + 1)
    # shelves/containers presets draw more stroke groups than a box has
    # faces — revisit faces for the excess (same deterministic draws as
    # before for n_faces <= 6)
    faces = rng.choice(6, size=min(int(n_faces), 6), replace=False)
    if n_faces > 6:
        faces = np.concatenate(
            [faces, rng.choice(6, size=int(n_faces) - 6, replace=True)])
    trajs, ids = [], []
    sid = 0
    for f in faces:
        n_passes = rng.integers(preset["passes"][0], preset["passes"][1] + 1)
        for _ in range(n_passes):
            n_lines = int(rng.integers(3, 6))
            ppl = int(rng.integers(8, 16))
            t = _raster_stroke(rng, dims, int(f), n_lines, ppl, standoff)
            trajs.append(t)
            ids.append(np.full(t.shape[0], sid, dtype=np.int64))
            sid += 1
    traj = np.concatenate(trajs, axis=0)
    stroke_ids = np.concatenate(ids, axis=0)
    return pc.astype(np.float32), traj.astype(np.float32), stroke_ids


class SyntheticPaintDataset:
    """Synthetic drop-in for the on-disk PaintNet category roots."""

    def __init__(self, category: str, split: str = "train", size: int = 32,
                 pc_points: int = 5120):
        self.category = category
        self.split = split
        self.size = size
        self.pc_points = pc_points
        self._offset = 0 if split == "train" else 10_000

    def __len__(self):
        return self.size

    def raw_item(self, idx: int):
        return generate_sample(self.category, self._offset + idx,
                               self.pc_points)
