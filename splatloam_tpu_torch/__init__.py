"""splatloam_tpu_torch — the PyTorch/CUDA port of ``splatloam_tpu``.

Module paths mirror the JAX package, so each counterpart is found at the
same place.  Plain tensor code is PyTorch; every Pallas kernel the port
has reached is a hand-written CUDA kernel under ``csrc/``, built at first
use (ops/rasterizer/kernels.py).  On a CPU tensor each kernel wrapper runs
the kernel's plain PyTorch version instead.

Layer map:
  geometry/   SE(3)/quaternion + spherical camera math
  ops/        rasterizer (tiled kernel path + eager golden renderer),
              KNN, projection
  model/      surfel pool + masked Adam, cameras, frames, submaps
  slam/       SLAM orchestrator, tracker (Gauss-Newton against the
              rendered map), mapper (densify -> optimize -> prune)
  io/         surfel PLY, trajectory files
  preprocessing, postprocessing (result graph), checkpoint, debug,
  profiling, logging_backends (the dummy data logger)
"""
import torch

# the geometry is pinned to full fp32 (splatloam_tpu/ops/rasterizer/
# common.py uses Precision.HIGHEST): no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
