"""Inference-time postprocessing (host-side).

Reference: ``utils/postprocessing.py``, ``utils/cluster.py``. The pipeline
turns the network's unordered segment set + stroke masks into executable
long-horizon robot trajectories:

1. masks -> per-segment stroke ids (``stroke_ids``)
2. filter overlapping/duplicate segments, per-stroke ordering via Edmonds
   minimum spanning arborescence + longest path (``concat``)
3. overlap removal, equal-space resampling, Akima upsample, Gaussian
   smoothing (``smoothing``)
"""
from .stroke_ids import (process_pred_stroke_masks_to_stroke_ids,
                         handle_end_of_sequence, from_stroke_ids_to_masks,
                         compute_total_path_length)

__all__ = [
    "process_pred_stroke_masks_to_stroke_ids",
    "from_stroke_ids_to_masks",
    "compute_total_path_length",
    "handle_end_of_sequence",
]
