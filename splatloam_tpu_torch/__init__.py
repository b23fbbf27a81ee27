"""splatloam_tpu_torch — the PyTorch/CUDA port of ``splatloam_tpu``.

Module paths mirror the JAX package, so each counterpart is found at the
same place.  Plain tensor code is PyTorch; every Pallas kernel the port
has reached is a hand-written CUDA kernel under ``csrc/``, built at first
use (ops/rasterizer/kernels.py).  On a CPU tensor each kernel wrapper runs
the kernel's plain PyTorch version instead.

Layer map, from the entry point down:
  cli.py, __main__.py
              ``python -m splatloam_tpu_torch slam|mesh|eval_odom|
              eval_recon|crop_recon|generate_dummy_cfg`` (``slam`` under
              torchrun for several ranks)
  io/         dataset readers (KITTI, VBR, NCD, Oxford Spires, generic)
              on point-cloud readers (BIN, PLY, PCD, ROS1/ROS2/MCAP
              bags) and the native host library (native.py); surfel PLY,
              trajectory files
  slam/       SLAM orchestrator, tracker (Gauss-Newton against the
              rendered map), mapper (densify -> optimize -> prune)
  parallel/   the mapper over a ("data", "model") mesh of
              torch.distributed ranks: rows / tiles / ring partitions,
              autograd collectives, send-byte accounting
  model/      surfel pool + masked Adam, cameras, frames, submaps
  ops/        rasterizer (tiled kernel path + eager golden renderer),
              KNN, projection
  geometry/   SE(3)/quaternion + spherical camera math
  eval/       odometry RPE, reconstruction metrics, TSDF fusion
  preprocessing, postprocessing (result graph), checkpoint, debug
  (NaN/Inf and id checks), profiling, logging_backends (dummy,
  tensorboard, rerun)
"""
import torch

# the geometry is pinned to full fp32 (splatloam_tpu/ops/rasterizer/
# common.py uses Precision.HIGHEST): no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
