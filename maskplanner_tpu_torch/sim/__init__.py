"""Spray-deposition simulation and the paint-coverage metric
(``maskplanner_tpu/sim``; ``coverage`` is the port's copy of the metric of
the repo-root ``standalone/compute_paint_coverage_per_face.py``)."""
from .coverage import (  # noqa: F401
    coverage_for_pair,
    get_thicknesses_values_per_face,
)
from .spray import (  # noqa: F401
    facevertex_thickness,
    pose_arclength_weights,
    simulate_program,
    simulate_spray,
    surface_centroid,
    write_thickness_csv,
)
