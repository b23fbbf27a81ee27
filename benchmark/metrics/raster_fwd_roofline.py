"""raster_fwd_roofline: K1's share of its roofline in the profiled
sub-window: the bound of one optimize iteration's forward (counts/, from
the pools and views of the sub-window's keyframe updates) over K1's mean
device time a launch (torch.profiler, by kernel name)."""
from counts import peaks, raster
import tracing


def read(run):
    durs = tracing.kernel_launches(run, "fwd")
    if not run.traced or not durs or not run.updates:
        return None
    c = raster.per_launch(run)
    if not c or c["pairs"] <= 0:
        return None
    bound = peaks.bound_s(c["pairs"] * raster.FWD_OPS_PER_PAIR,
                          raster.fwd_bytes(c["surfels"], c["pixels"]))
    return 100.0 * bound / (sum(durs) * 1e-9 / len(durs))
