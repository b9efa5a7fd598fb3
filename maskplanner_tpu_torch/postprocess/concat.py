"""Segment concatenation: order a stroke's segments into one path.

Reference: ``utils/cluster.py:12-102``. Segment endpoints are enriched with
inferred velocities (weight 1.5); a kNN(5)/radius(0.2) directed graph of
end→start squared distances is reduced to its minimum spanning
arborescence (Edmonds/Chu-Liu) whose unweighted longest path gives the
segment order. Graphs are ≤ a few hundred nodes; this runs on the host
after inference.
"""
from __future__ import annotations

import numpy as np

VEL_WEIGHT = 1.5
RADIUS = 0.2
KNN = 5


def _endpoint_features(traj: np.ndarray, outdim: int):
    """Start/end poses augmented with the inferred *starting* velocity
    (the reference attaches the starting velocity to both endpoints,
    utils/cluster.py:41-44)."""
    starts = traj[:, :outdim]
    ends = traj[:, -outdim:]
    if traj.shape[1] >= outdim + 3:
        vel_start = VEL_WEIGHT * (traj[:, outdim : outdim + 3] - traj[:, :3])
    else:
        # λ=1 rows are single poses — no second pose to infer a velocity
        # from; endpoint distances alone drive the ordering
        vel_start = np.zeros((traj.shape[0], 3), traj.dtype)
    starts = np.concatenate([starts, vel_start], axis=-1)
    ends = np.concatenate([ends, vel_start], axis=-1)
    return starts, ends


def concat_segments_of_stroke(traj: np.ndarray, stroke_ids, config,
                              verbose: int = 0) -> np.ndarray:
    """Order the segments of one stroke; returns the reordered subset
    (segments off the main path are dropped, like the reference)."""
    return traj[order_path_indices(traj, config, verbose=verbose)].copy()


def order_path_indices(traj: np.ndarray, config,
                       verbose: int = 0) -> np.ndarray:
    """Indices of the stroke's segments along the Edmonds longest path.

    The reference (utils/cluster.py:83-89) executes only this path —
    segments off it are silently dropped. Exposing the indices lets the
    caller recover the leftovers (``segments.split_offpath_strokes``):
    round-5 root-causing showed the dropped segments are the dominant
    cause of every category's coverage floor (docs/floor_rootcause.md)."""
    import networkx as nx

    from ..data.pointcloud import get_dim_traj_points

    outdim = get_dim_traj_points(config["extra_data"])
    assert traj.shape[1] == outdim * config["lambda_points"]
    n = traj.shape[0]
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    k = min(n, KNN)

    # native fast path: endpoint features + kNN digraph + C++
    # Chu-Liu/Edmonds + longest path in ONE call (the Python graph build
    # dominated the per-stroke cost once Edmonds itself was native)
    from . import native

    path = native.concat_order(np.asarray(traj, np.float64),
                               config["lambda_points"], outdim, RADIUS, k)
    if path is not None:
        if verbose and len(path) != n:
            print(f"stroke concat dropped {n - len(path)}/{n} segments")
        return np.asarray(path, dtype=np.int64)

    starts, ends = _endpoint_features(np.asarray(traj, np.float64), outdim)
    d2 = ((ends[:, None, :] - starts[None, :, :]) ** 2).sum(-1)  # end_i -> start_j
    nn_idx = np.argsort(d2, axis=1)[:, :k]

    if native.available():
        big = RADIUS
        masked = np.full_like(d2, big * 10.0)
        rows = np.repeat(np.arange(n), k)
        cols = nn_idx.reshape(-1)
        keep = (rows != cols) & (d2[rows, cols] < RADIUS)
        masked[rows[keep], cols[keep]] = d2[rows[keep], cols[keep]]
        path = native.edmonds_longest_path(masked, big=big * 5.0)
        if path:
            if verbose and len(path) != n:
                print(f"stroke concat dropped {n - len(path)}/{n} segments")
            return np.asarray(path, dtype=np.int64)

    from networkx.algorithms.tree import branchings

    G = nx.DiGraph()
    G.add_nodes_from(range(n))
    for i in range(n):
        for j in nn_idx[i]:
            if i != j and d2[i, j] < RADIUS:
                G.add_edge(i, int(j), weight=float(d2[i, j]))

    # minimal_branching == the reference's removed
    # Edmonds.find_optimum(kind='min', style='spanning arborescence')
    # (utils/cluster.py:83-84): every node takes its cheapest in-edge
    # regardless of sign, spanning where possible and a forest of
    # arborescences on disconnected graphs.
    arb = branchings.minimal_branching(G)
    for _, _, attrs in arb.edges(data=True):
        attrs.pop("weight", None)
    path = nx.dag_longest_path(arb)
    if verbose and len(path) != n:
        print(f"stroke concat dropped {n - len(path)}/{n} segments")
    return np.asarray(list(path), dtype=np.int64)
