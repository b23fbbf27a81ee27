#!/usr/bin/env python3
"""Where the captured port's numbers part from the uncaptured one's, on
one GPU: chip_smoke's phase 4 (the street-canyon sequence with gsaligner
tracking) and phase 8 (the NCD mapping-gt configuration) run with the
mapper's optimize blocks uncaptured, once with Adam's bias corrections
computed by numpy on the host (the port's code before the step moved to
the device) and once on the device; then phase 4 four times in this
process, captured and uncaptured in turns, its poses and pools compared
bitwise.  Prints each run's chip_smoke lines and one ``[attribution]``
line per pair of phase 4 runs.

    python3 tools/capture_attribution.py            # from the repo root

It needs a GPU; it imports no JAX.
"""
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from splatloam_tpu_torch.model import surfels as S  # noqa: E402
from splatloam_tpu_torch.ops.rasterizer import kernels  # noqa: E402
from splatloam_tpu_torch.slam import mapper as M  # noqa: E402


def host_adam_step(surfels, state, grads, hyper):
    """S.adam_step with its bias corrections from numpy's float32 power
    on the host, as the port computed them before (it reads the step
    back, so it runs uncaptured only)."""
    step = int(state.step) + 1
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.float32(hyper.b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(hyper.b2) ** t)
    lrs = S.SurfelParams(xyz=hyper.lr_xyz, log_scale=hyper.lr_scale,
                         quat=hyper.lr_quat, logit_opacity=hyper.lr_opacity)
    active = surfels.active
    out = [], [], []
    for p, g, m, v, lr in zip(surfels.params, grads, state.mu, state.nu,
                              lrs):
        mask = active.reshape((-1,) + (1,) * (p.ndim - 1))
        g = torch.where(mask, g, 0.0)
        m = hyper.b1 * m + (1 - hyper.b1) * g
        v = hyper.b2 * v + (1 - hyper.b2) * g * g
        update = lr * (m / c1) / (torch.sqrt(v / c2) + hyper.eps)
        for acc, x in zip(out, (p - torch.where(mask, update, 0.0), m, v)):
            acc.append(x)
    return (S.Surfels(S.SurfelParams(*out[0]), active),
            S.AdamState(S.SurfelParams(*out[1]), S.SurfelParams(*out[2]),
                        S.adam_step_count(step, active.device)))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cs.fail = lambda msg: print(f"[attribution] gate missed: {msg}",
                                flush=True)
    kernels.build_all()
    dev = torch.device("cuda")
    captures_on, device_adam = M.MapperPrograms.captures_on, S.adam_step

    def uncaptured(self, device):
        return False

    M.MapperPrograms.captures_on = uncaptured
    for name, step in (("host numpy corrections", host_adam_step),
                       ("device corrections", device_adam)):
        S.adam_step = step
        print(f"[attribution] phases 4 and 8 uncaptured, {name}",
              flush=True)
        cs.run_sequence(dev)
        with tempfile.TemporaryDirectory() as tmp:
            cs.run_recon(dev, Path(tmp))
    S.adam_step = device_adam

    runs = []
    for capture in (True, False, True, False):
        M.MapperPrograms.captures_on = captures_on if capture else uncaptured
        slam = cs.run_sequence(dev)[3]
        m = slam.local_models[-1]
        runs.append(("captured" if capture else "uncaptured",
                     np.stack(slam.world_T_odom), m.surfels.active.cpu(),
                     [p.cpu() for p in m.surfels.params]))
    M.MapperPrograms.captures_on = captures_on
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            (a, pa, act_a, par_a), (b, pb, act_b, par_b) = runs[i], runs[j]
            same = bool(torch.equal(act_a, act_b))
            params = (max(float((x - y).abs().max())
                          for x, y in zip(par_a, par_b))
                      if same else "-")
            print(f"[attribution] phase 4 run {i} ({a}) against run {j} "
                  f"({b}): poses max |diff| {np.abs(pa - pb).max():.3e} m, "
                  f"active surfels {int(act_a.sum())} / {int(act_b.sum())}, "
                  f"active masks equal {same}, parameters max |diff| "
                  f"{params}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
