"""The port's counterparts of the repo-root ``standalone/`` coverage tools,
each runnable with ``python -m maskplanner_tpu_torch.standalone.<tool>``
and taking the same flags:

1. ``from_pred_to_offline_v2``: a run's eval dumps -> robot programs;
2. ``simulate_spray_thickness``: programs + meshes -> per-face-vertex
   thickness CSVs (``sim.spray``);
3. ``compute_paint_coverage_per_face``: thickness CSVs -> coverage
   (``sim.coverage``).
"""
