#!/usr/bin/env python3
"""The committed VBR bag (tests/fixtures/vbr_seq.bag) through one
package's `slam` command on the CPU, once per mapper seed.

Prints each seed's odometry (TUM rows: t x y z qx qy qz qw) and, over
the seeds, the largest spread of each frame's position, so that the
tolerance of a comparison between the JAX package and the PyTorch port
on this bag can be set from how far one package moves with its own
random numbers (the packages draw theirs apart):

    python tools/bag_seed_spread.py --package torch --seeds 0 1 2 3
    JAX_PLATFORMS=cpu python tools/bag_seed_spread.py --package jax

The configuration is chip_smoke.VBR_CFG (tests/test_cli_vendor.py's),
with the JAX package on its jnp backend.  Each run imports one package.
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

BAG = ROOT / "tests" / "fixtures" / "vbr_seq.bag"


def seeded(package: str, seed: int) -> None:
    """Make every Mapper the package builds draw from ``seed``."""
    if package == "jax":
        import jax
        from splatloam_tpu.slam import mapper
        init = mapper.Mapper.__init__

        def reseed(self, *a, **k):
            init(self, *a, **k)
            self._key = jax.random.PRNGKey(seed)
    else:
        from splatloam_tpu_torch.slam import mapper
        init = mapper.Mapper.__init__

        def reseed(self, *a, **k):
            init(self, *a, **k)
            self.generator.manual_seed(seed)
    mapper.Mapper.__init__ = reseed


def run(package: str, seed: int, tmp: Path) -> np.ndarray:
    cfg = tmp / f"{package}-{seed}.yaml"
    out = tmp / f"{package}-{seed}"
    cfg.write_text(chip_smoke.VBR_CFG.format(bag=BAG, out=out))
    if package == "jax":
        from splatloam_tpu import cli
        from splatloam_tpu.logging_backends import reset_datalogger
        reset_datalogger()
        argv = ["slam", str(cfg), "compute.backend=jnp"]
    else:
        from splatloam_tpu_torch import cli
        argv = ["slam", str(cfg), "--device", "cpu"]
    cli.main(argv)
    (rdir,) = out.iterdir()
    return np.loadtxt(rdir / "odom.txt", ndmin=2)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if args.package == "torch":
        import torch
        torch.set_num_threads(1)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            seeded(args.package, seed)
            t = time.perf_counter()
            rows = run(args.package, seed, Path(tmp))
            print(f"seed {seed} ({time.perf_counter() - t:.1f} s): "
                  f"{np.round(rows[:, 1:4], 6).tolist()}", flush=True)
            runs.append(rows)
    xyz = np.stack([r[:, 1:4] for r in runs])
    spread = np.linalg.norm(xyz.max(axis=0) - xyz.min(axis=0), axis=-1)
    print(f"{args.package}: per-frame position spread over seeds "
          f"{args.seeds}: {np.round(spread, 6).tolist()} m, "
          f"max {spread.max():.6f} m")


if __name__ == "__main__":
    main()
