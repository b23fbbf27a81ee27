"""The plain reference: range images and the 2DGS renderer, worked out
again from the sweeps, and the comparison that decides ``correct``."""
