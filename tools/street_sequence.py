#!/usr/bin/env python3
"""The street-canyon sequence of chip_smoke.py's phase 4 through one
package's Preprocessor + SLAM on the CPU, at a width the CPU can take.

Prints each frame's position error against GT, so the JAX package and
the PyTorch port can be compared on the same sweeps (the two draw their
random numbers apart, so their maps differ):

    python tools/street_sequence.py --package jax --height 32 --width 512
    python tools/street_sequence.py --package torch --height 32 --width 512

``--fov full`` makes the sweeps of the whole sphere around the sensor
instead of the KITTI sensor's vertical field of view.  Each run imports
one package only.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--iterations", type=int, default=60)
    ap.add_argument("--fov", choices=("kitti", "full"), default="kitti")
    args = ap.parse_args()
    overrides = ["logging.enable=false",
                 f"preprocessing.image_height={args.height}",
                 f"preprocessing.image_width={args.width}",
                 f"mapping.num_iterations={args.iterations}"]
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from splatloam_tpu.config import load_configuration
        from splatloam_tpu.preprocessing import Preprocessor
        from splatloam_tpu.slam import SLAM
        # the golden jnp renderer holds [capacity, pixels] arrays: start
        # the pool small (it grows by doubling)
        cfg = load_configuration(ROOT / "configs/kitti/kitti.yaml",
                                 overrides + ["compute.initial_capacity=4096"])
        pre, slam = Preprocessor(cfg), SLAM(cfg)
    else:
        from splatloam_tpu_torch.config import load_configuration
        from splatloam_tpu_torch.preprocessing import Preprocessor
        from splatloam_tpu_torch.slam import SLAM
        cfg = load_configuration(ROOT / "configs/kitti/kitti.yaml",
                                 overrides)
        pre = Preprocessor(cfg, device="cpu")
        slam = SLAM(cfg, device="cpu", seed=chip_smoke.SEED)
    fov = chip_smoke.SENSOR_FOV_DEG if args.fov == "kitti" else None
    rng = np.random.default_rng(chip_smoke.SEED)
    step = chip_smoke.SEQ_STEP_M
    sweeps = [chip_smoke.sensor_sweep(rng, step * i, chip_smoke.SEQ_POINTS,
                                      fov)
              for i in range(chip_smoke.SEQ_SWEEPS)]
    t0 = time.perf_counter()
    for i, cloud in enumerate(sweeps):
        pose = np.eye(4)
        pose[0, 3] = step * i
        slam.process(pre(cloud, 0.1 * i, gt_pose=pose))
    err = [np.round(T[:3, 3] - [step * i, 0.0, 0.0], 4).tolist()
           for i, T in enumerate(slam.world_T_odom)]
    t_err = [float(np.linalg.norm(e)) for e in err]
    print(f"{args.package} {args.height}x{args.width} fov {args.fov}, "
          f"{args.iterations} iterations, {time.perf_counter() - t0:.1f} s; "
          f"keyframes {sum(len(m.keyframes) for m in slam.local_models)}, "
          f"surfels {[m.no_gaussians for m in slam.local_models]}")
    print(f"max translation error {max(t_err):.4f} m "
          f"(gate {chip_smoke.TRACK_GATE_M}); per frame (x, y, z) off GT "
          f"{err}")


if __name__ == "__main__":
    main()
