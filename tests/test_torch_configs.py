"""Every shipped config in both packages, and the reconstruction
configuration (configs/ncd/quad-easy-mapping-gt.yaml: GT poses, a
keyframe every 6 frames, densify 0.4, 30-keyframe submaps, uniform replay,
the active scale penalty) run by both at a small size on the CPU.

The JAX package renders with its golden jnp backend; the port with its
tiled path ("cuda", each kernel's plain version on the CPU).  The mapper
draws of the JAX run (its key sequence) are handed to the port, so the two
runs differ only in float order.  The sweeps are chip_smoke.py phase 8's:
the street canyon cast in a 90-degree vertical field of view.
"""
import contextlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from splatloam_tpu import config as jconfig
from splatloam_tpu.logging_backends import reset_datalogger as j_reset
from splatloam_tpu.preprocessing import Preprocessor as JPreprocessor
from splatloam_tpu.slam import SLAM as JSLAM
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch import logging_backends
from splatloam_tpu_torch.convert import surfels_to_numpy
from splatloam_tpu_torch.model.local_model import LocalModel
from splatloam_tpu_torch.ops.rasterizer.api import (RenderParams,
                                                    prepare_tiles, rasterize)
from splatloam_tpu_torch.preprocessing import Preprocessor
from splatloam_tpu_torch.slam import SLAM
from splatloam_tpu_torch.slam.mapper import Mapper

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO))
                 for p in (REPO / "configs").glob("*/*.yaml"))
NCD_GT = "configs/ncd/quad-easy-mapping-gt.yaml"
# the fields whose values differ between the packages by design: the
# rasterizer backends each package has (JAX: auto/jnp/pallas, the port:
# auto/cuda/eager), and the config file's device field, which each
# package ignores (JAX: "tpu", the port: "cuda")
BY_DESIGN = {("compute", "backend"): ({"auto", "jnp", "pallas"},
                                      {"auto", "cuda", "eager"}),
             ("device",): ({"tpu"}, {"cuda"})}

# the NCD settings at 16x128 (the sensor's 1:8 aspect): 7 frames 0.1 m
# apart give the keyframes at frames 0 and 6 (a keyframe once more than 5
# frames were tracked); 15 iterations run as one rebin block of 16 Adam
# steps.  The JAX package's golden renderer composites every pool row at
# every pixel: at 32x256 and the default 32,768 rows its first update
# alone took 318 s on this CPU, so the pool starts at 4096 rows
H, W, N_FRAMES, STEP = 16, 128, 7, chip_smoke.RECON_STEP_M
SMALL = ["mapping.num_iterations=15", "logging.enable=false"]


def _size(h, w):
    return [f"preprocessing.image_height={h}",
            f"preprocessing.image_width={w}"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths run thousands of small ops; beside the other
    workers of a parallel test run, torch's intra-op thread pool would
    oversubscribe the cores and wait in its barriers.  One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.config, "
            "splatloam_tpu_torch.slam, splatloam_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def test_every_shipped_config_is_listed():
    assert len(CONFIGS) == 14
    assert NCD_GT in CONFIGS


def _pop(d: dict, path: tuple):
    for k in path[:-1]:
        d = d[k]
    return d.pop(path[-1])


def _load(mod, name, overrides=()):
    """``name`` loaded by the config module ``mod`` from the repository
    root, where the configs' ``inherit_from`` paths start."""
    with contextlib.chdir(REPO):
        return mod.load_configuration(name, list(overrides))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_alike(name):
    """The config, its ``inherit_from`` chain resolved, loads in both
    packages to the same configuration, field by field, apart from the
    fields of BY_DESIGN, each of which holds one of its package's own
    values."""
    j = jconfig.to_dict(_load(jconfig, name))
    p = pconfig.to_dict(_load(pconfig, name))
    for path, (j_values, p_values) in BY_DESIGN.items():
        assert _pop(j, path) in j_values, path
        assert _pop(p, path) in p_values, path
    assert p == j
    # the chain resolved: the base file's preprocessing section is in it
    assert p["preprocessing"]["image_width"] == 1024
    assert p["preprocessing"]["image_height"] in (64, 128)


def _ncd_cfgs(tmp_path):
    """(JAX config on its jnp backend, port config on the cuda backend):
    the shipped NCD mapping-gt config at 32x256, each writing its own
    results."""
    def load(mod, backend, tag):
        return _load(mod, NCD_GT, [
            *SMALL, *_size(H, W), "compute.initial_capacity=4096",
            f"compute.backend={backend}", f"output.folder={tmp_path / tag}"])
    return load(jconfig, "jnp", "jax"), load(pconfig, "cuda", "port")


def _sweeps(h=H, w=W, n=N_FRAMES):
    rng = np.random.default_rng(0)
    poses, clouds = [], []
    for i in range(n):
        pose = np.eye(4)
        pose[0, 3] = STEP * i
        poses.append(pose)
        clouds.append(chip_smoke.sensor_raster(rng, STEP * i, h, w,
                                               chip_smoke.RECON_FOV_DEG))
    return poses, clouds


def _hand_jax_draws(port_mapper):
    """The JAX mapper's draws (its PRNGKey(0) sequence: one key for each
    densify's Gumbel noise, one for each optimize's per-block keyframe
    indices) given to the port's mapper."""
    state = {"key": jax.random.PRNGKey(0)}

    def next_key():
        state["key"], sub = jax.random.split(state["key"])
        return sub

    def gumbel(n):
        return torch.tensor(np.asarray(jax.random.gumbel(next_key(), (n,))))

    def draw(probs, n_blocks, newest):
        n = int((probs > 0).sum())
        lp = np.full(probs.shape, -np.inf, np.float32)
        lp[:n] = np.log(np.maximum(probs[:n], 1e-30))
        keys = jax.random.split(next_key(), n_blocks)
        return torch.tensor([int(jax.random.categorical(k, jnp.asarray(lp)))
                             for k in keys])

    port_mapper._gumbel = gumbel
    port_mapper._draw_keyframes = draw


@pytest.fixture(scope="module")
def ncd_runs(tmp_path_factory):
    """Both packages over the same 7 sweeps, in lockstep; each frame's
    active count in each."""
    jcfg, pcfg = _ncd_cfgs(tmp_path_factory.mktemp("ncd"))
    poses, clouds = _sweeps()
    j_reset()
    logging_backends.reset_datalogger()
    jslam, jpre = JSLAM(jcfg), JPreprocessor(jcfg)
    pslam, ppre = SLAM(pcfg, device="cpu"), Preprocessor(pcfg, device="cpu")
    _hand_jax_draws(pslam.mapper)
    counts = []
    for i, (cloud, pose) in enumerate(zip(clouds, poses)):
        jslam.process(jpre(cloud, 0.1 * i, gt_pose=pose))
        pslam.process(ppre(cloud, 0.1 * i, gt_pose=pose))
        counts.append((jslam.local_models[-1].no_gaussians,
                       pslam.local_models[-1].no_gaussians))
    return dict(cfg=pcfg, poses=poses, jax=jslam, port=pslam, counts=counts)


def test_ncd_mapping_gt_settings(ncd_runs):
    """The shipped values the small run keeps."""
    cfg = ncd_runs["cfg"]
    mc, tc = cfg.mapping, cfg.tracking
    assert (mc.densify_percentage, mc.prob_view_last_keyframe,
            mc.opt_scaling_max, mc.opt_scaling_max_penalty,
            mc.lmodel_threshold_ngaussians,
            mc.lmodel_threshold_nkeyframes) == (0.4, None, 0.1, 1.0, None,
                                                30)
    assert (tc.method.value, tc.keyframe_threshold_nframes) == ("gt", 5)
    assert cfg.data.skip_clouds_wno_sync
    assert len(ncd_runs["port"].local_models[-1].keyframes) == 2


def test_ncd_mapping_gt_poses_and_counts(ncd_runs):
    """GT tracking: both packages' odometry equals the GT poses bit for
    bit; the same surfels are written and pruned at every frame."""
    for est_j, est_p, gt in zip(ncd_runs["jax"].world_T_odom,
                                ncd_runs["port"].world_T_odom,
                                ncd_runs["poses"]):
        np.testing.assert_array_equal(est_p, est_j)
        np.testing.assert_allclose(est_p, gt, atol=1e-12)
    counts = ncd_runs["counts"]
    assert all(j == p for j, p in counts), counts
    assert counts[-1][0] > counts[0][0] > 300


# The pool after the two updates, held in bulk.  The tiled path sums in
# another order than a golden renderer, and under the active scale
# penalty most surfels sit on its kink (their KNN scale clamped at
# opt_scaling_max, 0.1 m, both scales tied): there the gradient's sign
# follows the float order, and Adam (eps 1e-15) moves such a surfel by up
# to a learning rate a step either way (a 1e-7 relative change of the
# start moved xyz up to 2.7e-3 m in tests/test_torch_parallel.py).  So
# the median difference per field is held to float precision, 1e-5, and
# the 99th percentile to tests/test_torch_mapper.py's pool tolerance,
# 1e-4 plus a learning rate per Adam step run.  The port's own eager
# renderer lands as far from its tiled path (tools/ncd_pool_spread.py).
POOL_P50 = 1e-5


def test_ncd_mapping_gt_pool_in_bulk(ncd_runs):
    jm = ncd_runs["jax"].local_models[-1]
    pm = ncd_runs["port"].local_models[-1]
    pp, pa, _ = surfels_to_numpy(pm.surfels)
    ja = np.asarray(jm.surfels.active)
    np.testing.assert_array_equal(pa, ja)
    oc = ncd_runs["cfg"].opt
    lrs = {"xyz": oc.position_lr, "log_scale": oc.scaling_lr,
           "quat": oc.rotation_lr, "logit_opacity": oc.opacity_lr}
    steps = int(pm.adam.step)
    assert steps == 2 * ncd_runs["port"].mapper.last_iters == 32
    for k, lr in lrs.items():
        d = np.abs(pp[k][pa] - np.asarray(getattr(jm.surfels.params, k))[ja])
        d = d.max(axis=-1) if d.ndim > 1 else d
        assert np.percentile(d, 50) <= POOL_P50, (k, np.percentile(d, 50))
        assert np.percentile(d, 99) <= 1e-4 + lr * steps, \
            (k, np.percentile(d, 99))


def test_update_past_a_doubling_renders_as_eager():
    """One initializing update at 32x256 (4 Adam steps) on a pool of 2048
    rows: the densify needs 3,278 free rows, so the pool doubles to 4096
    and the mapper's programs re-specialize (tile list capacity 256 ->
    512).  The re-specialized tiled path renders the map as the eager
    renderer does, at the render's tolerances (tests/test_pallas_raster.py:
    alpha 2e-5, depth and normal sums 2e-4), with no tile list full."""
    h, w = 32, 256
    cfg = _load(pconfig, NCD_GT, [*_size(h, w), "logging.enable=false",
                                  "compute.backend=cuda",
                                  "compute.initial_capacity=2048",
                                  "mapping.num_iterations=3",
                                  "compute.rebin_every=4"])
    _, clouds = _sweeps(h, w, 1)
    frame = Preprocessor(cfg, device="cpu")(clouds[0], 0.0,
                                            gt_pose=np.eye(4))
    model = LocalModel(cfg, device="cpu")
    mapper = Mapper(cfg, device="cpu")
    mapper.register_model(model)
    k_before = mapper.programs_for(h, w, 2048).params.tile_list_capacity
    model.insert_keyframe(frame)
    mapper.update_model(frame, initialize_model=True)
    assert model.capacity == 4096 and mapper.last_iters == 4
    params = mapper.programs_for(h, w, model.capacity).params
    assert (k_before, params.tile_list_capacity) == (256, 512)

    cam = frame.camera_in_model()
    s = model.surfels
    scene = (s.params.xyz, s.scaling, s.rotation, s.opacity, cam.T_cw, cam.K)
    with torch.no_grad():
        tiles = prepare_tiles(*scene, params)
        tiled = rasterize(*scene, params, tiles=tiles)
        eager = rasterize(*scene, RenderParams(h, w, backend="eager"))
    assert int(tiles.counts.max()) < params.tile_list_capacity
    assert float(tiled["alpha"].max()) > 0.5
    for k, tol in (("alpha", 2e-5), ("depth_sum", 2e-4),
                   ("normal_sum", 2e-4)):
        np.testing.assert_allclose(tiled[k].numpy(), eager[k].numpy(),
                                   atol=tol, err_msg=k)
