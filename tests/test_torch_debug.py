"""The port's debug functions bound to JAX in the reference
(splatloam_tpu_torch.debug: enable_checks, checked, audit_donation), the
counterparts of tests/test_debug.py, and `slam --debug-checks nans` on a
2-frame CPU run through the CLI.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from splatloam_tpu_torch import cli, debug
from splatloam_tpu_torch.geometry import se3, spherical
from splatloam_tpu_torch.model import surfels as S
from splatloam_tpu_torch.ops.rasterizer import kernels
from splatloam_tpu_torch.ops.rasterizer.api import RenderParams, render
from tests.test_cli import _make_kitti_dataset, _write_cfg

GEO = dict(height=16, width=256, chunk=128, tile_h=8, tile_w=32,
           tile_list_capacity=512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other workers of a parallel test run, torch's intra-op
    thread pool would oversubscribe the cores.  One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _checks_off():
    """Every test leaves the process-wide checks off."""
    yield
    debug.enable_checks("off")


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.debug, "
            "splatloam_tpu_torch.ops.rasterizer.api; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _scene(n=150, seed=0):
    """Sensor-facing surfels on a cylinder wall, as tensors on the CPU."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, n)
    xyz = torch.tensor(np.stack([7 * np.cos(theta), 7 * np.sin(theta),
                                 rng.uniform(-1.0, 1.5, n)], -1),
                       dtype=torch.float32)
    quat = se3.quat_from_normal(-xyz / torch.linalg.norm(xyz, dim=-1,
                                                         keepdim=True))
    scales = torch.tensor(rng.uniform(0.2, 0.6, (n, 2)), dtype=torch.float32)
    opac = torch.tensor(rng.uniform(0.3, 0.95, n), dtype=torch.float32)
    K = spherical.spherical_intrinsics(xyz, GEO["height"], GEO["width"])[0]
    return [xyz, scales, quat, opac, torch.eye(4), K]


def _render(scene, **kw):
    return render(*scene, RenderParams(backend="cuda", **GEO, **kw))


def test_checked_raises_on_nan():
    run = debug.checked(torch.log)
    np.testing.assert_allclose(run(torch.ones(4)).numpy(), 0.0, atol=1e-7)
    with pytest.raises(FloatingPointError, match="<output>"):
        run(-torch.ones(4))


def test_checked_names_the_first_bad_leaf():
    def f(x):
        return {"ok": x, "depth": x / 0.0 - x / 0.0, "inf": x / 0.0}

    with pytest.raises(FloatingPointError, match=r"\['depth'\]"):
        debug.checked(f)(torch.ones(3))


def test_checked_render_and_backward_pass():
    """A healthy render and its backward under ``checked``: every kernel
    wrapper's id check holds (no false alarm) and the outputs are
    finite."""
    scene = _scene()
    leaves = [t.clone().requires_grad_(True) for t in scene[:4]]

    def step(kw, *a):
        out = _render([*a, *scene[4:]], **kw)
        loss = out["surf_depth"].sum() + out["rend_alpha"].sum()
        return torch.autograd.grad(loss, a)

    for kw in ({"scatter": "ranksum"}, {"scatter": "rmw"},
               {"scatter": "fused"}, {"scatter": "plan"},
               {"layout": "flat"}, {"scatter": "rmw", "scatter_tps": 2}):
        grads = debug.checked(step)(kw, *leaves)
        assert all(bool(torch.isfinite(g).all()) for g in grads), kw


def test_checked_turns_on_the_id_checks():
    """Inside ``checked`` a list id past the pool raises IndexError before
    the kernel (here its plain version) runs; outside, nothing is
    checked."""
    F = torch.zeros((11, 16))
    lists = torch.full((2, 128), 10, dtype=torch.int32)
    counts = torch.tensor([3, 0], dtype=torch.int32)
    rays = torch.zeros((2, 32, 3))
    rays[..., 0] = 1.0
    pix = torch.zeros((2, 32, 2))

    def fwd(lists):
        return kernels.raster_fwd(F, lists, counts, rays, pix, chunk=128,
                                  width=256, with_median=False,
                                  with_dist=False)

    out, _ = debug.checked(fwd)(lists)
    assert not debug.index_checks_active()
    bad = lists.clone()
    bad[0, 1] = 11
    with pytest.raises(IndexError, match="K1 lists: 1 ids outside"):
        debug.checked(fwd)(bad)
    assert not debug.index_checks_active()
    ranks = torch.tensor([0, 1, 5, -1], dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)
    pad = torch.tensor([9], dtype=torch.int32)
    with pytest.raises(IndexError, match="K3 ranks"):
        debug.checked(kernels.ranksum_rows)(torch.ones((4, 16)), pos, ranks,
                                           pad, 5)
    assert debug.checked(kernels.ranksum_rows)(
        torch.ones((4, 16)), pos, ranks, pad, 6).shape == (6, 16)


def test_audit_donation_reports_buffer_reuse():
    """In place, the outputs hold the donated argument's storage; a
    functional step, like the port's adam_step, returns new tensors."""
    state = {"xyz": torch.ones((128, 3)), "opa": torch.zeros((128, 1))}
    g = {k: torch.ones_like(v) for k, v in state.items()}

    def step_inplace(state, g):
        return {k: v.sub_(0.1 * g[k]) for k, v in state.items()}

    def step(state, g):
        return {k: v - 0.1 * g[k] for k, v in state.items()}

    assert debug.audit_donation(step_inplace, (state, g), (0,)) == {0: True}
    assert debug.audit_donation(step, (state, g), (0, 1)) == \
        {0: False, 1: False}

    surf, adam = S.empty_surfels(16, "cpu"), S.empty_adam(16, "cpu")
    grads = S.SurfelParams(*(torch.ones_like(p) for p in surf.params))
    report = debug.audit_donation(
        lambda s, a, g: S.adam_step(s, a, g, S.AdamHyper()),
        (surf, adam, grads), (0, 1))
    assert report == {0: False, 1: False}


def test_enable_checks_roundtrip():
    """Under "nans" a render whose outputs hold a NaN (a NaN scale gives
    its surfel a NaN radius) raises; "infs" lets NaNs through; a bad
    mode changes nothing; "off" turns every check off."""
    scene = _scene()
    bad = list(scene)
    bad[1] = scene[1].clone()
    bad[1][0, 0] = float("nan")
    debug.enable_checks("nans")
    assert torch.is_anomaly_enabled()
    _render(scene)                        # healthy: no raise
    with pytest.raises(FloatingPointError,
                       match=r"render: 1 NaN values in output \['radii'\]"):
        _render(bad)
    with pytest.raises(ValueError):
        debug.enable_checks("bogus")
    assert torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError):
        _render(bad)
    debug.enable_checks("infs")
    _render(bad)
    debug.enable_checks("off")
    assert not torch.is_anomaly_enabled()
    _render(bad)


def test_slam_cli_debug_checks_nans(tmp_path):
    """`slam --debug-checks nans` with logging.debug_checks on a 2-frame
    CPU run: anomaly mode, checked renders and the per-keyframe state
    check all pass on a healthy run."""
    seq, gt = _make_kitti_dataset(tmp_path, np.random.default_rng(0),
                                  n_frames=2)
    cfg = _write_cfg(tmp_path, seq, gt)
    cli.main(["slam", str(cfg), "--device", "cpu", "--debug-checks", "nans",
              "compute.backend=auto", "mapping.num_iterations=8",
              "logging.debug_checks=true",
              "tracking.keyframe_threshold_nframes=0"])
    assert torch.is_anomaly_enabled()
    results = sorted((tmp_path / "results").iterdir())
    odom = np.loadtxt(results[-1] / "odom.txt")
    assert odom.shape == (2, 12)
    assert np.isfinite(odom).all()
