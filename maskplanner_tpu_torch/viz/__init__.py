"""Visualization (matplotlib-based): the port's copy of
``maskplanner_tpu/viz`` (numpy and matplotlib only).

matplotlib is imported here and by ``render_results`` alone: nothing on the
driver's, the server's or the kernels' import path loads this package (the
driver reaches ``render_results`` through a child process).

Reference: ``utils/visualize.py`` (pyvista renderers). Without pyvista or
OpenGL, the renderers here produce equivalent artifacts
(per-stroke colored trajectories over the object point cloud, GT/pred
side-by-side comparisons, batch grids, orientation quivers) with
matplotlib 3D — headless-safe PNG output.
"""
from .render import (
    stroke_colors,
    visualize_traj,
    visualize_mesh_traj,
    visualize_sample_pred_gt,
    visualize_batch_grid,
    visualize_mesh_traj_animated,
    visualize_mesh_traj_multiangle,
    visualize_latent_segments,
    visualize_latent_segments_batch,
    visualize_pc,
    visualize_sops,
    visualize_box,
    visualize_boxes,
    visualize_sequence_traj,
    visualize_centroid_traj,
    visualize_complete_traj,
    visualize_complete_traj_tour,
)

__all__ = [
    "stroke_colors",
    "visualize_traj",
    "visualize_mesh_traj",
    "visualize_sample_pred_gt",
    "visualize_batch_grid",
    "visualize_mesh_traj_animated",
    "visualize_mesh_traj_multiangle",
    "visualize_latent_segments",
    "visualize_latent_segments_batch",
    "visualize_pc",
    "visualize_sops",
    "visualize_box",
    "visualize_boxes",
    "visualize_sequence_traj",
    "visualize_centroid_traj",
    "visualize_complete_traj",
    "visualize_complete_traj_tour",
]
