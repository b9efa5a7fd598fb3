"""Data pipeline (``maskplanner_tpu/data``): the port's own copies of the
numpy-only host modules, ``fixture_category`` (the on-disk fixture corpus)
among them. ``legacy`` is not copied yet."""
from .dataset import PaintDataset, DataLoader, collate, segment_budget, point_budget
from .synthetic import SyntheticPaintDataset, generate_sample
