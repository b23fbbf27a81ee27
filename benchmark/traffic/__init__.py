"""Traffic: the sweep generator and its scenes (data files)."""
