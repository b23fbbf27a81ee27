#!/usr/bin/env python3
"""tests/test_torch_configs.py's small NCD mapping-gt run (the shipped
configs/ncd/quad-easy-mapping-gt.yaml at 16x128, 7 sweeps of chip_smoke
phase 8's street canyon, the JAX mapper's draws handed to the port) on
the CPU, three times: the JAX package on its jnp backend, the port on its
tiled path ("cuda", the kernels' plain versions) and the port on its
eager golden renderer.  Prints, per pool field, the 99th percentile and
the largest |difference| over the active surfels of (tiled - JAX) and of
(eager - tiled): the second is the float-order spread within the port,
from which the test's pool tolerance is set.

    JAX_PLATFORMS=cpu python tools/ncd_pool_spread.py
"""
import copy
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import test_torch_configs as t  # noqa: E402
from splatloam_tpu_torch.config import RasterBackend  # noqa: E402

FIELDS = ("xyz", "log_scale", "quat", "logit_opacity")


def run_port(cfg, poses, clouds):
    slam, pre = t.SLAM(cfg, device="cpu"), t.Preprocessor(cfg, device="cpu")
    t._hand_jax_draws(slam.mapper)
    for i, (cloud, pose) in enumerate(zip(clouds, poses)):
        slam.process(pre(cloud, 0.1 * i, gt_pose=pose))
    return t.surfels_to_numpy(slam.local_models[-1].surfels)[:2]


def report(tag, a, b):
    (pa, ma), (pb, mb) = a, b
    if not np.array_equal(ma, mb):
        print(f"{tag}: the active masks differ")
        return
    for k in FIELDS:
        d = np.abs(pa[k][ma] - pb[k][mb])
        d = d.max(axis=-1) if d.ndim > 1 else d
        print(f"{tag} {k}: p99 {np.percentile(d, 99):.3e}, max "
              f"{d.max():.3e} over {int(ma.sum())} surfels")


def main():
    torch.set_num_threads(1)
    jcfg, pcfg = t._ncd_cfgs(Path(tempfile.mkdtemp()))
    poses, clouds = t._sweeps()
    jslam, jpre = t.JSLAM(jcfg), t.JPreprocessor(jcfg)
    for i, (cloud, pose) in enumerate(zip(clouds, poses)):
        jslam.process(jpre(cloud, 0.1 * i, gt_pose=pose))
    jm = jslam.local_models[-1].surfels
    jax_pool = ({k: np.asarray(getattr(jm.params, k)) for k in FIELDS},
                np.asarray(jm.active))
    tiled = run_port(pcfg, poses, clouds)
    ecfg = copy.deepcopy(pcfg)
    ecfg.compute.backend = RasterBackend.eager
    eager = run_port(ecfg, poses, clouds)
    report("tiled - JAX", tiled, jax_pool)
    report("eager - tiled", eager, tiled)


if __name__ == "__main__":
    main()
