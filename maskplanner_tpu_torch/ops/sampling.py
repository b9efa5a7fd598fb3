"""Point sampling and grouping (``maskplanner_tpu/ops/sampling.py``).

``farthest_point_sample`` and ``query_ball_point`` launch their CUDA
kernels for a CUDA tensor and run their plain versions (:func:`fps_plain`,
:func:`ball_query_plain`) for a CPU tensor; any other device raises.
"""
from __future__ import annotations

import torch

from .distance import square_distance

_BIG = 1e10


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, ...) int -> (B, ..., C)."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def fps_plain(xyz: torch.Tensor, npoint: int,
              start: torch.Tensor) -> torch.Tensor:
    """Plain farthest point sampling: (B, N, 3), (B,) start -> (B, npoint)
    int32. Ties go to the lowest index (``argmax`` returns the first
    maximum); once every point is picked all distances are 0 and index 0
    repeats."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    rows = torch.arange(B, device=xyz.device)
    far = start.long()
    dist = torch.full((B, N), _BIG, dtype=torch.float32, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        diff = xyz - xyz[rows, far][:, None, :]
        d = diff[..., 0] * diff[..., 0]
        d = d + diff[..., 1] * diff[..., 1]
        d = d + diff[..., 2] * diff[..., 2]
        dist = torch.minimum(dist, d)
        far = torch.argmax(dist, dim=-1)
    return out


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: torch.Tensor | None = None) -> torch.Tensor:
    """Iterative farthest point sampling -> (B, npoint) int32 indices.

    ``start``: optional (B,) start indices in [0, N); the default starts
    every cloud at index 0 (the deterministic eval path). On the CPU a start
    outside raises ``ValueError``; on the card the kernel checks it and
    traps, so that the host does not wait for the device."""
    B, N, _ = xyz.shape
    if start is None:
        start = torch.zeros(B, dtype=torch.int32, device=xyz.device)
    if xyz.device.type == "cuda":
        from .cuda.fps import fps_cuda

        return fps_cuda(xyz, npoint, start)
    if xyz.device.type == "cpu":
        if bool(((start < 0) | (start >= N)).any()):
            raise ValueError(f"FPS start indices must lie in [0, {N})")
        return fps_plain(xyz, npoint, start)
    raise ValueError(f"no FPS for device {xyz.device}")


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
