"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit), frozen from chip_smoke.py's PEAK_BYTES
and PEAK_F32."""

# HBM3 bytes/s
PEAK_BYTES = 3.35e12
# float32 outside the tensor cores, FLOP/s
PEAK_F32 = 67e12


def bound_s(n_ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the float32 peak and bytes over the memory bandwidth."""
    return max(n_ops / PEAK_F32, n_bytes / PEAK_BYTES)
