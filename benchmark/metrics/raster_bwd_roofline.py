"""raster_bwd_roofline: K2's share of its roofline in the profiled
sub-window, counted as raster_fwd_roofline's with the backward's
operations and bytes."""
from counts import peaks, raster
import tracing


def read(run):
    durs = tracing.kernel_launches(run, "bwd")
    if not run.traced or not durs or not run.updates:
        return None
    c = raster.per_launch(run)
    if not c or c["pairs"] <= 0:
        return None
    bound = peaks.bound_s(c["pairs"] * raster.BWD_OPS_PER_PAIR,
                          raster.bwd_bytes(c["surfels"], c["pixels"]))
    return 100.0 * bound / (sum(durs) * 1e-9 / len(durs))
