"""Point sampling and grouping (``maskplanner_tpu/ops/sampling.py``).

``farthest_point_sample`` and ``query_ball_point`` launch their CUDA
kernels for a CUDA tensor and run their plain versions (:func:`fps_plain`,
:func:`ball_query_plain`) for a CPU tensor; any other device raises. FPS
goes through the custom op ``maskplanner::fps`` (``ops.library``), which
``torch.export`` traces. The CUDA kernels take points in R³; the plain
versions take any number of coordinates, as the JAX package's plain
versions do. :func:`knn` is plain PyTorch (the JAX package's has no
kernel either).
"""
from __future__ import annotations

import torch

from . import library
from .distance import smallest_k, square_distance, square_distance_expanded

_BIG = 1e10


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, ...) int -> (B, ..., C)."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def fps_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain farthest point sampling: (B, N, D), (B,) start -> (B, npoint)
    int32, the squared distances summed over the D coordinates in order.
    Ties go to the lowest index (``argmax`` returns the first maximum);
    once every point is picked all distances are 0 and index 0 repeats.

    ``mask`` (B, N) bool, the valid points (the JAX package's
    ``farthest_point_sample(mask=...)``): an invalid point's running
    distance starts at −1e10, so it is never picked while a valid one
    remains; an invalid start becomes the cloud's first valid point (0
    when none is); once every valid point is picked the lowest valid index
    repeats, and a cloud without valid points repeats index 0."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    rows = torch.arange(B, device=xyz.device)
    far = start.long()
    dist = torch.full((B, N), _BIG, dtype=torch.float32, device=xyz.device)
    if mask is not None:
        dist = torch.where(mask, dist, -_BIG)
        first_valid = mask.to(torch.uint8).argmax(dim=1)
        far = torch.where(mask[rows, far], far, first_valid)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        diff = xyz - xyz[rows, far][:, None, :]
        d = diff[..., 0] * diff[..., 0]
        for c in range(1, xyz.shape[-1]):
            d = d + diff[..., c] * diff[..., c]
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)
    return out


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: torch.Tensor | None = None,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Iterative farthest point sampling -> (B, npoint) int32 indices.

    ``start``: optional (B,) start indices in [0, N); the default starts
    every cloud at index 0 (the deterministic eval path). On the CPU a start
    outside raises ``ValueError``; on the card the kernel checks it and
    traps, so that the host does not wait for the device. ``mask``:
    optional (B, N) validity (:func:`fps_plain`'s semantics; the kernel's
    masked mode on the card)."""
    if xyz.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no FPS for device {xyz.device}")
    if start is None:
        start = torch.zeros(xyz.shape[0], dtype=torch.int32,
                            device=xyz.device)
    return library.fps(xyz, npoint, start.to(torch.int32),
                       None if mask is None else mask.to(torch.bool))


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """First ``nsample`` in-radius (``<=`` radius²) indices per query, in
    ascending index order; missing slots repeat the first one, and an empty
    ball gives index 0. xyz (B, N, 3), new_xyz (B, S, 3) -> (B, S, nsample)
    int32."""
    if xyz.device.type == "cuda":
        from .cuda.group_gather import ball_query_cuda

        return ball_query_cuda(radius, nsample, xyz, new_xyz)
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    raise ValueError(f"no ball query for device {xyz.device}")


def ball_query_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`query_ball_point`: the (B, S, N) distances,
    then the ``nsample`` smallest in-radius indices (with ``nsample`` > N,
    the slots past the N points repeat the first, as every missing slot
    does)."""
    N = xyz.shape[1]
    within = square_distance(new_xyz, xyz) <= radius ** 2       # (B, S, N)
    idx = torch.arange(N, device=xyz.device)
    masked = torch.where(within, idx, N)
    if nsample > N:
        masked = torch.nn.functional.pad(masked, (0, nsample - N), value=N)
    group = torch.topk(masked, nsample, dim=-1, largest=False,
                       sorted=True).values
    group = torch.where(group == N, group[..., :1], group)
    return torch.where(group == N, 0, group).to(torch.int32)


def knn(k: int, query: torch.Tensor, points: torch.Tensor,
        points_mask: torch.Tensor | None = None, expanded: bool = False):
    """Masked k nearest neighbours: query (B, S, C), points (B, N, C) ->
    (squared distances (B, S, k) ascending, indices (B, S, k) int64), ties
    to the lower index (``ops.distance.smallest_k``, ``jax.lax.top_k``'s
    order). Points outside ``points_mask`` (B, N) lie at ``_BIG``. The
    distances are the fixed-order ones (``square_distance``), or with
    ``expanded`` the matmul expansion (``square_distance_expanded``, for
    the wide feature space of ``models.dgcnn``); the gradient reaches
    them through the chosen entries."""
    form = square_distance_expanded if expanded else square_distance
    d = form(query, points)
    if points_mask is not None:
        d = torch.where(points_mask[:, None, :], d, _BIG)
    return smallest_k(d, k)
