"""Evaluation: odometry RPE (eval/recon.py and eval/tsdf.py are not ported
yet, ROADMAP.md queue 1 item 4)."""
from .odometry import evaluate_rpe  # noqa: F401
