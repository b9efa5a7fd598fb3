"""Write a fabricated PaintNet category to disk (real dataset layout).

The proprietary PaintNet data ships as ``$PAINTNET_ROOT/<category>/
<item>/{<item>.obj, <item>_trajectory.txt}`` plus ``{train,test}_split
.json`` (reference ``utils/disk.py:85-110,184-220``). This generator
materializes the synthetic box-raster objects of
:mod:`maskplanner_tpu.data.synthetic` in exactly that on-disk layout —
triangulated OBJ meshes, ``;``-separated Euler-angle trajectory programs
in workspace (mm-like) scale — so the full disk pipeline (mesh sampling,
npz preprocessing cache, per-dataset normalization, export, spray
simulation, coverage) can be exercised end to end without the real data.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .io import orientnorm_to_euler, save_traj_file
from .synthetic import CATEGORY_PRESETS, _raster_stroke

# 12-triangle box with outward-oriented faces
_BOX_FACES = np.array([
    [0, 1, 3], [0, 3, 2],      # -x
    [4, 6, 7], [4, 7, 5],      # +x
    [0, 4, 5], [0, 5, 1],      # -y
    [2, 3, 7], [2, 7, 6],      # +y
    [0, 2, 6], [0, 6, 4],      # -z
    [1, 5, 7], [1, 7, 3],      # +z
], np.int64)


def box_mesh(dims: np.ndarray, max_edge: float | None = None):
    """Axis-aligned box centred at the origin -> (verts, tris).

    ``max_edge=None`` keeps the minimal 8-vertex / 12-triangle box (the
    cheap default for pipeline tests). With ``max_edge`` set, every face
    is subdivided into a quad grid of at most that edge length — the
    coverage metric (% of GT-covered faces also covered by the
    prediction, reference ``compute_paint_coverage_per_face.py:62-114``)
    is computed *per mesh face*, and the real PaintNet meshes carry
    thousands of faces; a 12-triangle box quantizes coverage into 1/12
    steps and turns the >99% target into an all-or-nothing per-face coin
    flip.
    """
    half = np.asarray(dims, np.float64) / 2.0
    if max_edge is None:
        verts = np.array([[sx * half[0], sy * half[1], sz * half[2]]
                          for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)])
        return verts, _BOX_FACES.copy()

    verts_out, tris_out, base = [], [], 0
    for face in range(6):
        axis = face // 2
        sign = 1.0 if face % 2 == 0 else -1.0
        u_axis, v_axis = [a for a in range(3) if a != axis]
        nu = max(1, int(np.ceil(2 * half[u_axis] / max_edge)))
        nv = max(1, int(np.ceil(2 * half[v_axis] / max_edge)))
        us = np.linspace(-half[u_axis], half[u_axis], nu + 1)
        vs = np.linspace(-half[v_axis], half[v_axis], nv + 1)
        uu, vv = np.meshgrid(us, vs, indexing="ij")        # (nu+1, nv+1)
        grid = np.zeros(uu.shape + (3,))
        grid[..., axis] = sign * half[axis]
        grid[..., u_axis] = uu
        grid[..., v_axis] = vv
        verts_out.append(grid.reshape(-1, 3))

        idx = np.arange((nu + 1) * (nv + 1)).reshape(nu + 1, nv + 1)
        c00 = idx[:-1, :-1].ravel()
        c01 = idx[:-1, 1:].ravel()
        c10 = idx[1:, :-1].ravel()
        c11 = idx[1:, 1:].ravel()
        quads = np.stack(
            [np.stack([c00, c01, c11], 1), np.stack([c00, c11, c10], 1)],
            axis=1).reshape(-1, 3)
        # orient outward: check one triangle's normal against sign*e_axis
        fv = verts_out[-1]
        a, b, c = fv[quads[0, 0]], fv[quads[0, 1]], fv[quads[0, 2]]
        if np.cross(b - a, c - a)[axis] * sign < 0:
            quads = quads[:, ::-1]
        tris_out.append(quads + base)
        base += (nu + 1) * (nv + 1)
    return np.concatenate(verts_out), np.concatenate(tris_out)


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")


def generate_item(category: str, index: int, seed: int = 0,
                  workspace_scale: float = 800.0,
                  deterministic: bool = False,
                  mesh_max_edge: float | None = None):
    """One fabricated object: (verts, faces, traj (T,6), stroke_ids).

    ``traj`` carries [x, y, z, nx, ny, nz] with the orientation normal =
    spray axis (inward face normal), all in workspace scale.

    ``deterministic=True`` makes the program a deterministic function of
    the mesh geometry — every face except the bottom is painted, and the
    raster line count / points-per-line derive from the face extents at a
    fixed pass spacing (real robot spray programs are deterministic
    expert demonstrations: pass pitch comes from the gun fan width, not
    from per-object dice). The default (random face subsets, random
    raster densities) is kept for pipeline/stress tests, but it injects
    label noise that no model can regress away — held-out coverage on it
    measures the noise ceiling, not the pipeline (docs/coverage.md).
    """
    import zlib

    preset = CATEGORY_PRESETS.get(category, CATEGORY_PRESETS["cuboids-v2"])
    cat_seed = zlib.crc32(category.encode())
    rng = np.random.default_rng(
        np.random.SeedSequence([cat_seed, index, seed, 7]))
    dims = rng.uniform(*preset["size"], size=3)
    standoff = 0.3 * dims.mean()

    if deterministic:
        trajs, ids = [], []
        sid = 0
        for f in (0, 1, 2, 3, 4):          # every face but the bottom (-z)
            axis = f // 2
            u_axis, v_axis = [a for a in range(3) if a != axis]
            n_lines = int(np.clip(round(0.9 * dims[u_axis] / 0.25) + 1,
                                  3, 8))
            ppl = int(np.clip(round(0.9 * dims[v_axis] / 0.10) + 1, 8, 18))
            # large faces get a second (offset) pass as its own stroke —
            # stroke count then varies per object as a deterministic
            # function of the geometry, so the stroke-count metrics
            # (MAE_NoP / %-correct) measure real mask-head generalization
            # instead of a constant
            area = dims[u_axis] * dims[v_axis]
            for p in range(2 if area > 0.9 else 1):
                t = _raster_stroke(rng, dims, f, n_lines=n_lines + p,
                                   pts_per_line=ppl, standoff=standoff)
                trajs.append(t)
                ids.append(np.full(t.shape[0], sid, np.int64))
                sid += 1
    else:
        n_faces = int(rng.integers(*preset["n_faces"]) if
                      preset["n_faces"][0] < preset["n_faces"][1]
                      else preset["n_faces"][0])
        faces_painted = rng.choice(6, size=min(max(n_faces, 1), 6),
                                   replace=False)
        trajs, ids = [], []
        for sid, f in enumerate(faces_painted):
            t = _raster_stroke(rng, dims, int(f),
                               n_lines=int(rng.integers(3, 6)),
                               pts_per_line=int(rng.integers(10, 18)),
                               standoff=standoff)
            trajs.append(t)
            ids.append(np.full(t.shape[0], sid, np.int64))
    traj = np.concatenate(trajs, axis=0)
    traj[:, :3] *= workspace_scale
    verts, tris = box_mesh(
        dims * workspace_scale,
        max_edge=None if mesh_max_edge is None
        else mesh_max_edge * workspace_scale)
    return verts, tris, traj, np.concatenate(ids)


def write_category(root: str, category: str, n_train: int = 6,
                   n_test: int = 2, seed: int = 0,
                   workspace_scale: float = 800.0,
                   deterministic: bool = False,
                   mesh_max_edge: float | None = None) -> str:
    """Materialize the category under ``root``; returns its directory."""
    cat_dir = os.path.join(root, category)
    names = [f"box_{i:03d}" for i in range(n_train + n_test)]
    for i, name in enumerate(names):
        d = os.path.join(cat_dir, name)
        os.makedirs(d, exist_ok=True)
        verts, tris, traj, ids = generate_item(
            category, i, seed, workspace_scale,
            deterministic=deterministic, mesh_max_edge=mesh_max_edge)
        write_obj(os.path.join(d, f"{name}.obj"), verts, tris)
        euler = orientnorm_to_euler(traj[:, 3:6])
        rows = np.concatenate(
            [traj[:, :3], euler, ids[:, None].astype(np.float64)], axis=1)
        save_traj_file(rows, os.path.join(d, f"{name}_trajectory.txt"),
                       kind="euler")
        # the real dataset names the program plainly ``trajectory.txt``
        # (reference paintnet_ODv1.py:154); write that name too so the
        # reference loader can consume the fixture directly
        import shutil
        shutil.copyfile(os.path.join(d, f"{name}_trajectory.txt"),
                        os.path.join(d, "trajectory.txt"))
    with open(os.path.join(cat_dir, "train_split.json"), "w") as f:
        json.dump(names[:n_train], f)
    with open(os.path.join(cat_dir, "test_split.json"), "w") as f:
        json.dump(names[n_train:], f)
    return cat_dir
