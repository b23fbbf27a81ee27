"""Evaluation: odometry RPE (odometry.py), reconstruction metrics
(recon.py) and TSDF fusion with marching tetrahedra and the grid Poisson
solver (tsdf.py)."""
from .odometry import evaluate_rpe  # noqa: F401
