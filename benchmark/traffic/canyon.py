"""The benchmark's one traffic generator: ray-cast LiDAR sweeps of a
periodic scene, made from ``(seed, frame index)``.

Adapted from ``chip_smoke.sensor_raster`` (a spinning LiDAR at (x, 0, 0):
``beams`` rows spread evenly over the vertical field of view and
``columns`` azimuth steps, each ray jittered within its cell, cast against
the scene's surfaces; a ray that hits nothing within ``max_range_m``
returns no point).  Two changes: the scene is data
(``scenes/<name>.json``: rectangles and poles of one period) repeated
along x without end, so a sensor that drives on never leaves it; and the
rays are cast on the device, in float64, before the sweep is handed over
as a host float32 array, as a sensor delivers it.

A traffic mix (``workloads/<cell>.json``, key ``traffic``) sets the
sensor (beams, columns, field of view, range), the motion (metres a
sweep along x from ``start_m``, seconds a sweep) and the scene's name.
The seed changes the rays' jitter, never the route: every seed drives
the same stretch of street.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

SCENES = Path(__file__).resolve().parent / "scenes"
RAY_BLOCK = 4096


def load_scene(name: str) -> dict:
    return json.loads((SCENES / f"{name}.json").read_text())


def stream_seed(seed: int, *words: int) -> int:
    """A 63-bit generator seed from the run's seed and ``words``."""
    if seed < 0:
        raise ValueError(f"seed {seed} is negative")
    state = np.random.SeedSequence([seed, *words]).generate_state(2,
                                                                  np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class SweepStream:
    """Sweep ``i`` and its ground-truth pose, for any ``i`` >= 0."""

    def __init__(self, traffic: dict, seed: int, device):
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.beams = int(traffic["beams"])
        self.columns = int(traffic["columns"])
        lo, hi = traffic["fov_deg"]
        self.el_lo, self.el_hi = math.radians(lo), math.radians(hi)
        self.max_range = float(traffic["max_range_m"])
        self.step = float(traffic["step_m"])
        self.start = float(traffic.get("start_m", 0.0))
        self.dt = float(traffic["frame_dt_s"])
        scene = load_scene(traffic["scene"])
        self.period = float(scene["period_m"])
        f64 = dict(dtype=torch.float64, device=self.device)
        self._rects = torch.tensor(scene["rects"], **f64).reshape(-1, 6)
        self._cyls = torch.tensor(scene["cylinders"], **f64).reshape(-1, 5)

    def position(self, i: int) -> float:
        return self.start + self.step * i

    def pose(self, i: int) -> np.ndarray:
        """world_T_sensor of sweep ``i`` (float64 [4, 4])."""
        pose = np.eye(4)
        pose[0, 3] = self.position(i)
        return pose

    def timestamp(self, i: int) -> float:
        return self.dt * i

    def rays(self, i: int) -> torch.Tensor:
        """[beams * columns, 3] unit directions of sweep ``i``, each
        jittered within its cell."""
        h, w = self.beams, self.columns
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(self.seed, 1, i))
        jitter = torch.rand((2, h, w), generator=gen, dtype=torch.float64,
                            device=self.device)
        rows = torch.arange(h, dtype=torch.float64, device=self.device)
        cols = torch.arange(w, dtype=torch.float64, device=self.device)
        el = self.el_hi - (rows[:, None] + jitter[0]) * \
            (self.el_hi - self.el_lo) / h
        az = -math.pi + (cols[None, :] + jitter[1]) * 2 * math.pi / w
        return torch.stack([torch.cos(el) * torch.cos(az),
                            torch.cos(el) * torch.sin(az),
                            torch.sin(el)], -1).reshape(-1, 3)

    def _periods(self, x: float):
        """The scene's rectangles and poles of the periods a ray from x can
        reach, in world coordinates."""
        k0 = math.floor(x / self.period)
        span = math.ceil(self.max_range / self.period)
        shifts = torch.arange(k0 - span, k0 + span + 1, dtype=torch.float64,
                              device=self.device) * self.period
        r = self._rects[None].repeat(len(shifts), 1, 1)
        along = r[..., 0] == 0
        r[..., 1] += torch.where(along, shifts[:, None], 0.0)
        # the x extent is the first bound pair of a y or z plane
        r[..., 2] += torch.where(along, 0.0, shifts[:, None])
        r[..., 3] += torch.where(along, 0.0, shifts[:, None])
        r = r.reshape(-1, 6)
        x_lo = torch.where(r[:, 0] == 0, r[:, 1], r[:, 2])
        x_hi = torch.where(r[:, 0] == 0, r[:, 1], r[:, 3])
        r = r[(x_hi >= x - self.max_range) & (x_lo <= x + self.max_range)]
        c = self._cyls[None].repeat(len(shifts), 1, 1)
        c[..., 0] += shifts[:, None]
        c = c.reshape(-1, 5)
        c = c[torch.abs(c[:, 0] - x) <= self.max_range + c[:, 2]]
        return r, c

    def ranges(self, origin, d: torch.Tensor, scene=None) -> torch.Tensor:
        """[n] distance along each ray ``d`` from ``origin`` (x, y, z) to
        the nearest surface, inf where none lies within range; ``scene``:
        the rectangles and poles near the origin (``_periods``)."""
        rects, cyls = scene or self._periods(origin[0])
        o = torch.tensor(origin, dtype=torch.float64, device=self.device)
        best = torch.full((d.shape[0],), math.inf, dtype=torch.float64,
                          device=self.device)
        others = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
        for axis, (a1, a2) in others.items():
            r = rects[rects[:, 0] == axis]
            if len(r) == 0:
                continue
            t = (r[:, 1:2] - o[axis]) / d[None, :, axis]
            p1 = o[a1] + t * d[None, :, a1]
            p2 = o[a2] + t * d[None, :, a2]
            ok = ((t > 0) & (p1 >= r[:, 2:3]) & (p1 <= r[:, 3:4])
                  & (p2 >= r[:, 4:5]) & (p2 <= r[:, 5:6]))
            t = torch.where(ok, t, math.inf)
            best = torch.minimum(best, t.amin(0))
        if len(cyls):
            q = o[None, :2] - cyls[:, :2]                      # [C, 2]
            a = (d[:, :2] ** 2).sum(-1)[None]                  # [1, n]
            b = 2 * (q @ d[:, :2].T)                           # [C, n]
            c = ((q ** 2).sum(-1) - cyls[:, 2] ** 2)[:, None]
            disc = b * b - 4 * a * c
            t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
            z = o[2] + t * d[None, :, 2]
            ok = ((disc >= 0) & (t > 0) & (z >= cyls[:, 3:4])
                  & (z <= cyls[:, 4:5]))
            best = torch.minimum(best, torch.where(ok, t, math.inf).amin(0))
        return torch.where(best <= self.max_range, best, math.inf)

    def sweep(self, i: int) -> np.ndarray:
        """[n, 3] float32 returns of sweep ``i`` in the sensor's frame, one
        per ray that hit, as a host array."""
        d = self.rays(i)
        origin = (self.position(i), 0.0, 0.0)
        # in blocks of rays, so that the cast's temporaries stay small
        # beside the program's memory
        scene = self._periods(origin[0])
        t = torch.cat([self.ranges(origin, d[k:k + RAY_BLOCK], scene)
                       for k in range(0, len(d), RAY_BLOCK)])
        hit = torch.isfinite(t)
        return (t[hit, None] * d[hit]).to(torch.float32).cpu().numpy()
