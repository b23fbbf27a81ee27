"""track_gap_m, tracking: the Gauss-Newton solve against the plain one.

``tap`` wraps the tracker's ``AlignerGN.align`` once set-up has ended
and keeps, for a sample of the window's tracked frames drawn from the
seed (the window's last tracked frame always among them), references to
the solve's inputs (the guess, the source points and mask, the target's
depth, points, normals and mask, K) and the pose the aligner returned.
References, not copies: each frame's source and target are tensors made
anew for it that nothing writes later (the tensors' version counters
are compared at ``observe``, and a tensor written since reads inf).
``compare`` redoes each sampled solve with the plain reference
(``reference/gauss_newton.py``, float64, the settings the configuration
states) and takes the largest distance between the frame's valid source
points moved by the program's pose and by the reference's; the check is
the largest over the sample, in metres.  Under ``control`` the reference
in TF32 takes the program's place.
"""
from __future__ import annotations

import math
import sys

import numpy as np

from reference import gauss_newton as gn
from traffic.canyon import stream_seed

N_SAMPLED = 8


class Sample:
    """N_SAMPLED - 1 of the records added before the newest, drawn
    uniformly from the seed (a reservoir), and the newest."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.kept: list[dict] = []
        self.seen = 0
        self.newest: dict | None = None

    def add(self, rec: dict) -> None:
        if self.newest is not None:
            self.seen += 1
            if len(self.kept) < N_SAMPLED - 1:
                self.kept.append(self.newest)
            else:
                j = int(self.rng.integers(self.seen))
                if j < N_SAMPLED - 1:
                    self.kept[j] = self.newest
        self.newest = rec

    def records(self) -> list[dict]:
        return self.kept + ([self.newest] if self.newest else [])


def tap(prog) -> None:
    aligner = prog.slam.tracker.aligner
    if not hasattr(aligner, "solver_settings"):
        raise ValueError("track_gap_m needs tracking.method gsaligner")
    sample = Sample(stream_seed(prog.stream.seed, 5))
    align = aligner.align

    def tapped(iguess):
        depth, pts, normals, valid, K = aligner._target[:5]
        inputs = (*aligner._source, depth, pts, normals, valid, K)
        T = align(iguess)
        sample.add(dict(index=prog.next_index - 1,
                        guess=np.array(iguess, np.float64),
                        T=np.array(T, np.float64), inputs=inputs,
                        versions=[t._version for t in inputs]))
        return T
    aligner.align = tapped
    prog.track_gap_sample = sample


def observe(prog, run, stream) -> dict:
    frames = []
    for rec in prog.track_gap_sample.records():
        if [t._version for t in rec["inputs"]] != rec["versions"]:
            print(f"track_gap_m: frame {rec['index']}'s solve inputs were "
                  "written after the solve", file=sys.stderr)
            return dict(frames=None)
        frames.append(dict(rec, inputs=[t.detach().clone()
                                        for t in rec["inputs"]]))
    return dict(frames=frames)


def compare(obs, stream, cfg, workload, control) -> float:
    if not obs["frames"]:
        return math.inf
    s = gn.settings(cfg)
    gaps = []
    for f in obs["frames"]:
        ref = gn.align(f["guess"], *f["inputs"], s)
        T = (gn.align(f["guess"], *f["inputs"], s, tf32=True) if control
             else f["T"])
        gaps.append(gn.point_gap(f["inputs"][0], f["inputs"][1], T, ref))
        print(f"track_gap_m: frame {f['index']} {gaps[-1]!r}",
              file=sys.stderr)
    return max(gaps)
