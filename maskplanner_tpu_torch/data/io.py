"""On-disk data IO for the PaintNet dataset layout.

Replaces the reference's ``utils/disk.py``: trajectory CSV parsing/export
(Euler yzx -> quaternion/rotvec/surface-normal conversions via scipy
Rotation), OBJ mesh loading + Poisson-disk surface sampling (the
point_cloud_utils C++ dependency is replaced by a numpy area-weighted
sampler with dart-throwing thinning — same ~10k-point contract), the
per-category normalization constants, dataset path resolution, and the
``paintnet_preprocessed_sample`` npz cache.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .pointcloud import orient_in

# precomputed average max vertex distance per category train set
# (reference utils/disk.py:16-43)
DATASET_DOWNSCALE_FACTORS = {
    "containers-v2": 884.1423249856435,
    "cuboids-v1": 888.7967305471634,
    "cuboids-v2": 889.6556509728579,
    "cuboids-small-v2": 885.8284752276212,
    "cuboids-discrete-v1": 881.05007396,
    "cuboids-discrete-xfixed-v1": 873.877203026212,
    "cuboids-large-v1": 888.0597387021147,
    "shelves-v1": 905.4091900499023,
    "shelves-v2": 424.2046732264433,
    "cuboids-v1-windows-v1-shelves-v1": 947.2448614376127,
    "windows-v1-shelves-v1-containers-v2": 969.337674913636,
    "cuboids-v1-shelves-v1-containers-v2": 895.6137144950626,
    "cuboids-v1-windows-v1-containers-v2": 961.3291445923128,
    "cuboids-v1-windows-v1-shelves-v1-containers-v2": 940.7008946944458,
    "cuboids-v2-windows-v2-shelves-v2-containers-v2": 779.2320060197117,
    "cuboids-v2-windows-v2-shelves-v2": 776.1721217165386,
    "windows-v1": 1157.9744613449216,
    "windows-v2": 1014.656040950315,
    "realtime_windows-v1": 1027.2274259059286,
}


def get_dataset_downscale_factor(category: str):
    return DATASET_DOWNSCALE_FACTORS.get(category)


def get_auxiliary_pretrained_custom_path(dataset, version: int = 2) -> str:
    """Path of the auxiliary SoP pretrained run per category
    (reference utils/disk.py:46-68)."""
    category = get_dataset_name(dataset)
    if version == 1:
        table = {
            "cuboids-v2": "pretrained_models/4T4BI-S42",
            "windows-v2": "pretrained_models/0WCLK-S42",
            "shelves-v2": "pretrained_models/TZOV8-S42",
            "containers-v2": "pretrained_models/CN000-S42",
        }
    else:
        table = {
            "cuboids-v2": "pretrained_models/sop_cuboids-v2/36FNJ-S46",
            "windows-v2": "pretrained_models/sop_windows-v2/I66C6-S48",
            "shelves-v2": "pretrained_models/sop_shelves-v2/39LI2-S46",
            "containers-v2": "pretrained_models/sop_containers/VDGKO-S47",
            "realtime_windows-v1": "pretrained_models/sop_windows-v2/I66C6-S48",
        }
    return table[category]


def get_dataset_name(dataset) -> str:
    """Joint-category list -> joined name (reference utils/disk.py:77-84)."""
    if isinstance(dataset, str):
        return dataset
    return "-".join(dataset)


def get_dataset_root() -> str:
    root = os.environ.get("PAINTNET_ROOT")
    assert root, "Set PAINTNET_ROOT environment variable"
    assert os.path.isdir(root), f"PAINTNET_ROOT does not exist: {root}"
    return root


def get_dataset_paths(categories) -> list[str]:
    if isinstance(categories, str):
        categories = [categories]
    return [os.path.join(get_dataset_root(), c) for c in categories]


# ---------------------------------------------------------------------------
# Trajectory files (reference utils/disk.py:184-271)
# ---------------------------------------------------------------------------

def _euler_yzx_to_orient(abc_deg: np.ndarray, kind: str) -> np.ndarray:
    """Euler (A,B,C degrees, applied as yzx=[B,C,A]) -> orientation repr."""
    from scipy.spatial.transform import Rotation as Rot

    rot = Rot.from_euler("yzx", abc_deg[:, [1, 2, 0]], degrees=True)
    if kind == "orientquat":
        return rot.as_quat()
    if kind == "orientrotvec":
        return rot.as_rotvec()
    if kind == "orientnorm":
        return rot.apply(np.array([1.0, 0.0, 0.0]))
    raise ValueError(kind)


def read_traj_file(filename: str, extra_data=(), weight_orient: float = 1.0):
    """Parse a ``trajectory.txt`` (``;``-separated, header
    X;Y;Z;A;B;C;strokeId) into (traj (T, 3|6|7), stroke_ids (T,))."""
    data = np.genfromtxt(filename, delimiter=";", skip_header=1,
                         dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    xyz = data[:, :3]
    stroke_ids = data[:, 6].astype(np.int64)
    has_orient, kind = orient_in(extra_data)
    if has_orient:
        orient = weight_orient * _euler_yzx_to_orient(data[:, 3:6], kind)
        traj = np.concatenate([xyz, orient], axis=1)
    else:
        traj = xyz
    return traj, stroke_ids


def orientnorm_to_euler(normals: np.ndarray) -> np.ndarray:
    """Surface normals -> Euler yzx angles (degrees) mapping e1 to the
    normal — inverse of the orientnorm parsing; used for simulator export
    (reference standalone/from_pred_to_offline_v2.py:196-241 via
    Rot.align_vectors)."""
    from scipy.spatial.transform import Rotation as Rot

    e1 = np.array([1.0, 0.0, 0.0])
    out = np.zeros((normals.shape[0], 3))
    for i, n in enumerate(normals):
        n = n / max(np.linalg.norm(n), 1e-12)
        rot, _ = Rot.align_vectors([n], [e1])
        y, z, x = rot.as_euler("yzx", degrees=True)
        out[i] = [x, y, z]  # back to (A, B, C) column order
    return out


def save_traj_file(traj: np.ndarray, filepath: str, kind: str = "normals"):
    """Export a trajectory CSV (reference utils/disk.py:241-271)."""
    assert traj.ndim == 2 and traj.shape[-1] in (3, 6, 7)
    k = traj.shape[-1]
    if kind == "normals":
        header = ["X", "Y", "Z", "W1", "W2", "W3", "strokeId"][:k]
        if k > 3:
            norms = np.linalg.norm(traj[:, 3:6], axis=-1)
            assert np.allclose(norms, 1, atol=0.02), "orientation not unit"
    elif kind == "euler":
        header = ["X", "Y", "Z", "A", "B", "C", "strokeId"][:k]
    else:
        raise ValueError(kind)
    with open(filepath, "w", encoding="utf-8") as f:
        print(";".join(header), file=f)
        for row in traj:
            print(";".join(map(str, row)), file=f)


def save_object(obj, save_dir: str, filename: str):
    """Pickle helper (reference utils/disk.py:291-297)."""
    import pickle

    with open(os.path.join(save_dir, f"{filename}.pkl"), "wb") as fh:
        pickle.dump(obj, fh, pickle.HIGHEST_PROTOCOL)


def load_object(filepath: str):
    import pickle

    with open(filepath, "rb") as fh:
        return pickle.load(fh)


# ---------------------------------------------------------------------------
# Mesh loading + surface sampling (point_cloud_utils replacement)
# ---------------------------------------------------------------------------

def find_mesh(meshes_root: str, name: str) -> str:
    """Resolve an item's mesh under a category root: the on-disk layout
    keeps ``<name>/<name>.obj``; flat ``<name>.obj`` is accepted too
    (single source for this rule — used by the render driver and the
    spray-sim tool)."""
    for cand in (os.path.join(meshes_root, name, f"{name}.obj"),
                 os.path.join(meshes_root, f"{name}.obj")):
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"no mesh for {name} under {meshes_root}")


def load_obj(filename: str):
    """Minimal OBJ loader: vertices + triangulated faces."""
    verts, faces = [], []
    with open(filename, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def sample_mesh_surface(v: np.ndarray, f: np.ndarray, n_points: int,
                        seed: int = 0, poisson: bool = True,
                        return_face_idx: bool = False):
    """Approximate Poisson-disk surface sampling.

    Area-weighted barycentric oversampling (4×) followed by greedy
    dart-throwing thinning at the radius implied by the target density —
    the same blue-noise contract as pcu.sample_mesh_poisson_disk
    (reference utils/disk.py:274-288) without the C++ dependency.
    Measured characterization (spacing, uniformity, throughput):
    docs/sampler.md / scripts/sampler_characterization.py.

    ``return_face_idx`` additionally returns each sample's source
    triangle (characterization / exact-ownership consumers).
    """
    rng = np.random.default_rng(seed)
    tri = v[f]  # (F, 3, 3)
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    total_area = areas.sum()
    probs = areas / total_area

    oversample = n_points * 4 if poisson else n_points
    face_idx = rng.choice(len(f), size=oversample, p=probs)
    r1, r2 = rng.random((2, oversample))
    su = np.sqrt(r1)
    bary = np.stack([1 - su, su * (1 - r2), su * r2], axis=1)
    pts = (tri[face_idx] * bary[:, :, None]).sum(axis=1)
    if not poisson:
        return (pts, face_idx) if return_face_idx else pts

    # dart throwing: grid hash at radius r = sqrt(area / (2·n)); cell
    # edge r/sqrt(3) holds at most one accepted point, and two points
    # within r can sit up to TWO cells apart per axis (coordinate delta
    # up to r = sqrt(3)·cell), so the conflict search spans ±2 cells
    radius = np.sqrt(total_area / (2.0 * n_points))
    cell = radius / np.sqrt(3)
    grid: dict[tuple, int] = {}
    chosen: list[int] = []
    keys = np.floor(pts / cell).astype(np.int64)
    order = rng.permutation(oversample)
    r2_thresh = radius * radius
    span = (-2, -1, 0, 1, 2)
    for i in order:
        k = tuple(keys[i])
        ok = True
        for dx in span:
            for dy in span:
                for dz in span:
                    j = grid.get((k[0] + dx, k[1] + dy, k[2] + dz))
                    if j is not None and ((pts[i] - pts[j]) ** 2).sum() < r2_thresh:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            grid[k] = i
            chosen.append(i)
            if len(chosen) >= n_points:
                break
    if return_face_idx:
        return pts[chosen], face_idx[chosen]
    return pts[chosen]


def read_mesh_as_pointcloud(filename: str, n_points: int = 10000,
                            return_more: bool = False):
    """OBJ mesh -> ~n_points surface samples
    (reference utils/disk.py:274-288)."""
    import zlib

    v, f = load_obj(filename)
    points = sample_mesh_surface(
        v, f, n_points,
        seed=zlib.crc32(os.path.basename(filename).encode()))
    if return_more:
        centroid = v.mean(axis=0)
        max_distance = np.linalg.norm(v - centroid, axis=1).max()
        return points, centroid, max_distance
    return points


# ---------------------------------------------------------------------------
# On-disk dataset source
# ---------------------------------------------------------------------------

class DiskPaintDataset:
    """PaintNet category root -> raw (pc, traj, stroke_ids) samples.

    Layout (reference utils/dataset/paintnet_ODv1.py:144-170): a category
    dir with per-sample subdirs containing ``<name>.obj`` +
    ``<name>_trajectory.txt`` (or ``trajectory.txt``), plus
    ``{train,test}_split.json`` listing sample names. Preprocessed samples
    are cached as npz next to the mesh under
    ``paintnet_preprocessed_sample/``.
    """

    def __init__(self, root: str, category: str, split: str = "train",
                 extra_data=("orientnorm",), weight_orient: float = 1.0,
                 n_mesh_points: int = 10000):
        self.root = os.path.join(root, category)
        self.category = category
        self.extra_data = list(extra_data)
        self.weight_orient = weight_orient
        self.n_mesh_points = n_mesh_points

        split_file = os.path.join(self.root, f"{split}_split.json")
        if os.path.isfile(split_file):
            with open(split_file) as fh:
                names = json.load(fh)
        else:
            names = sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d))
                and not d.startswith("paintnet_preprocessed"))
            cut = max(1, int(len(names) * 0.8))
            names = names[:cut] if split == "train" else names[cut:]
        self.samples = list(names)

    def __len__(self):
        return len(self.samples)

    def _paths(self, name: str):
        d = os.path.join(self.root, name)
        mesh = next((os.path.join(d, f) for f in os.listdir(d)
                     if f.endswith(".obj")), None)
        traj = next((os.path.join(d, f) for f in os.listdir(d)
                     if f.endswith("trajectory.txt")), None)
        assert mesh and traj, f"missing mesh/trajectory in {d}"
        return mesh, traj

    def raw_item(self, idx: int):
        name = self.samples[idx]
        mesh_file, traj_file = self._paths(name)
        cache_dir = os.path.join(os.path.dirname(mesh_file),
                                 "paintnet_preprocessed_sample")
        key = f"preprocessed_{'-'.join(self.extra_data)}_w{self.weight_orient}.npz"
        cache = os.path.join(cache_dir, key)
        if os.path.isfile(cache):
            data = np.load(cache)
            return data["point_cloud"], data["traj"], data["stroke_ids"]
        pc = read_mesh_as_pointcloud(mesh_file, self.n_mesh_points)
        traj, stroke_ids = read_traj_file(traj_file, self.extra_data,
                                          self.weight_orient)
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(cache, point_cloud=pc, traj=traj, stroke_ids=stroke_ids)
        return (pc.astype(np.float32), traj.astype(np.float32),
                stroke_ids.astype(np.int64))

    def centroid(self, idx: int) -> np.ndarray:
        """Mesh vertex centroid — the reference's centering convention
        (``center_pair`` -> ``get_mean_mesh``, utils/pointcloud.py:24-37):
        pairs are shifted by the mean of the mesh *vertices*, not of the
        sampled point cloud."""
        mesh_file, _ = self._paths(self.samples[idx])
        return get_mean_mesh(mesh_file)


# centroid/extent are re-read per item materialization (every dataset
# item centers on its mesh's vertex centroid) — memoize the OBJ parse,
# it's a full text scan of a 10k+-vertex file per call otherwise
_MESH_STATS_CACHE: dict = {}


def _mesh_vertex_stats(meshpath):
    key = (os.path.abspath(meshpath), os.path.getmtime(meshpath))
    hit = _MESH_STATS_CACHE.get(key)
    if hit is None:
        if len(_MESH_STATS_CACHE) > 10000:
            _MESH_STATS_CACHE.clear()
        v, _ = load_obj(meshpath)
        c = v.mean(axis=0)
        r = float(np.sqrt(((v - c) ** 2).sum(axis=1)).max())
        hit = _MESH_STATS_CACHE[key] = (c, r)
    return hit


def get_mean_mesh(meshpath):
    """Vertex centroid of a mesh file (reference utils/pointcloud.py:24-28)."""
    return _mesh_vertex_stats(meshpath)[0].copy()


def get_max_distance(meshpath):
    """Max vertex distance from the mesh centroid — the per-mesh
    normalization scale (reference utils/pointcloud.py:15-21)."""
    return _mesh_vertex_stats(meshpath)[1]
