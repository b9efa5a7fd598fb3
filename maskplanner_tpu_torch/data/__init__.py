"""Data pipeline (``maskplanner_tpu/data``): the port's own copies of the
numpy-only host modules. ``legacy`` and ``fixture_category`` are not
copied yet."""
from .dataset import PaintDataset, DataLoader, collate, segment_budget, point_budget
from .synthetic import SyntheticPaintDataset, generate_sample
