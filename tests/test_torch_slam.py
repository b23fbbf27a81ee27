"""The PyTorch port's per-frame pipeline (Preprocessor + SLAM.process) on
the synthetic world of tests/synthetic.py at 16x128, on the CPU (the
tiled render path's kernels run their plain versions), against the JAX
package where the two are deterministic: GT tracking, shared pools,
shared Gumbel noise.  The packages draw their random numbers apart, so
their maps differ; odometry, submap chains, results files and
checkpoints do not.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import synthetic
import torch
import yaml

from splatloam_tpu import checkpoint as jckpt
from splatloam_tpu import config as jconfig
from splatloam_tpu.io import ply as jply
from splatloam_tpu.logging_backends import reset_datalogger as j_reset
from splatloam_tpu.model import surfels as JS
from splatloam_tpu.model.camera import make_camera as j_make_camera
from splatloam_tpu.model.frame import Frame as JFrame
from splatloam_tpu.preprocessing import Preprocessor as JPreprocessor
from splatloam_tpu.preprocessing import _preprocess_device
from splatloam_tpu.slam import SLAM as JSLAM
from splatloam_tpu.slam import mapper as jmapper
from splatloam_tpu.slam.tracker import Tracker as JTracker
from splatloam_tpu_torch import checkpoint, debug, logging_backends
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch.convert import surfels_from_numpy
from splatloam_tpu_torch.io import ply
from splatloam_tpu_torch.model import surfels as S
from splatloam_tpu_torch.model.camera import make_camera
from splatloam_tpu_torch.model.frame import Frame
from splatloam_tpu_torch.model.local_model import LocalModel
from splatloam_tpu_torch.ops.rasterizer.api import RenderParams, render
from splatloam_tpu_torch.postprocessing import ResultGraph
from splatloam_tpu_torch.preprocessing import Preprocessor
from splatloam_tpu_torch.profiling import Profiler
from splatloam_tpu_torch.slam import SLAM
from splatloam_tpu_torch.slam import mapper
from splatloam_tpu_torch.slam.tracker import Tracker

STEP = 0.4


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
    code = ("import sys, splatloam_tpu_torch.slam, "
            "splatloam_tpu_torch.checkpoint; "
            "from splatloam_tpu_torch.slam import SLAM; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_slam_needs_a_gpu_or_cpu_by_name(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SLAM(_cfgs(tmp_path)[1])


def _cfgs(tmp_path, **overrides):
    """(JAX config on its jnp backend, port config on the cuda backend),
    synthetic.make_config's settings, each writing its own results."""
    jcfg = synthetic.make_config(tmp_path / "jax", **overrides)
    d = jconfig.to_dict(jcfg)
    d["compute"]["backend"] = "cuda"
    d["output"]["folder"] = str(tmp_path / "port" / "results")
    return jcfg, pconfig.from_dict(pconfig.Configuration, d)


def _clouds(n_frames, seed=0):
    rng = np.random.default_rng(seed)
    poses = synthetic.straight_trajectory(n_frames, step=STEP)
    return poses, [synthetic.sensor_cloud(rng, p) for p in poses]


def _run(slam, pre, poses, clouds, frames):
    for i in frames:
        slam.process(pre(clouds[i], 0.1 * i, gt_pose=poses[i]))


def test_mapping_gt_end_to_end(tmp_path):
    """The port's run of tests/test_e2e_slam.py's mapping-GT case."""
    logging_backends.reset_datalogger()
    _, cfg = _cfgs(tmp_path, mapping={"num_iterations": 60})
    poses, clouds = _clouds(5)
    slam = SLAM(cfg, device="cpu")
    _run(slam, Preprocessor(cfg, device="cpu"), poses, clouds, range(5))
    assert len(slam.world_T_odom) == 5
    for est, gt in zip(slam.world_T_odom, poses):
        np.testing.assert_allclose(est, gt, atol=1e-5)
    model = slam.local_models[-1]
    assert model.no_gaussians > 500

    # the optimized model fits the first keyframe's depth (golden render)
    kf = model.keyframes[0]
    cam = kf.camera_in_model()
    s = model.surfels
    out = render(s.params.xyz, s.scaling, s.rotation, s.opacity, cam.T_cw,
                 cam.K, RenderParams(cam.height, cam.width, backend="eager"))
    valid = cam.valid.numpy()
    l1 = np.abs(out["surf_depth"].numpy() - cam.depth.numpy())
    assert np.median(l1[valid]) < 0.25

    result_dir = slam.save_results()
    for name in ("cfg.yaml", "odom.txt", "graph.yaml"):
        assert (result_dir / name).is_file()
    assert pconfig.load_configuration(result_dir / "cfg.yaml") \
        .mapping.num_iterations == 60
    plys = sorted((result_dir / "models").glob("*.ply"))
    assert len(plys) == len(slam.local_models)
    graph = ResultGraph.from_yaml(result_dir / "graph.yaml")
    assert len(graph.models) == len(slam.local_models)
    assert len(graph.frames) == sum(len(m.keyframes)
                                    for m in slam.local_models)
    arrs = S.compact_arrays(model.surfels)
    for load in (ply.load_surfel_ply, jply.load_surfel_ply):
        xyz, opac, scale, quat = load(plys[0])
        assert len(xyz) == model.no_gaussians
        np.testing.assert_array_equal(xyz, arrs["xyz"])
        np.testing.assert_array_equal(quat, arrs["quat"])


# ---------------------------------------------------------------------------
# Submap rollover and checkpoints, in both packages on the same clouds
# ---------------------------------------------------------------------------

N_FRAMES, N_CKPT, N_RESUMED = 8, 4, 2
ROLLOVER = dict(
    mapping={"num_iterations": 10, "lmodel_threshold_nkeyframes": 2,
             "densify_percentage": 0.2},
    tracking={"method": "gt", "keyframe_threshold_nframes": 1,
              "keyframe_threshold_distance": -1,
              "keyframe_threshold_fitness": -1})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's 8-frame GT-tracked run with submap rollover, a
    checkpoint after frame 4 and its results; then each package resumed
    from the other's checkpoint and the port from its own, over the next
    2 frames."""
    tmp = tmp_path_factory.mktemp("rollover")
    jcfg, pcfg = _cfgs(tmp, **ROLLOVER)
    poses, clouds = _clouds(N_FRAMES)
    out = {"poses": poses}
    for tag, make, pre in (
            ("jax", lambda: JSLAM(jcfg), JPreprocessor(jcfg)),
            ("port", lambda: SLAM(pcfg, device="cpu"),
             Preprocessor(pcfg, device="cpu"))):
        j_reset()
        logging_backends.reset_datalogger()
        slam = make()
        _run(slam, pre, poses, clouds, range(N_CKPT))
        ckpt = (jckpt if tag == "jax" else checkpoint).save_checkpoint(
            tmp / f"ckpt_{tag}", slam)
        _run(slam, pre, poses, clouds, range(N_CKPT, N_FRAMES))
        out[tag] = slam
        out[f"{tag}_ckpt"] = ckpt
        out[f"{tag}_results"] = slam.save_results()
        out[f"{tag}_pre"] = pre
    # resumed runs: (who resumes, whose checkpoint)
    for who, whose in (("port", "jax"), ("jax", "port"), ("port", "port")):
        if who == "port":
            slam = SLAM(pcfg, device="cpu")
        else:
            slam = JSLAM(jcfg)
            # the JAX mapper's compiled programs depend only on the config
            # and the shapes: reuse the first run's instead of compiling
            slam.mapper._programs = out["jax"].mapper._programs
        load = checkpoint.load_checkpoint if who == "port" \
            else jckpt.load_checkpoint
        assert load(out[f"{whose}_ckpt"], slam) == N_CKPT
        restored = [_pool_arrays(m) for m in slam.local_models]
        _run(slam, out[f"{who}_pre"], poses, clouds,
             range(N_CKPT, N_CKPT + N_RESUMED))
        out[f"{who}_from_{whose}"] = (slam, restored)
    return out


def _pool_arrays(model) -> dict:
    """Params, active mask and Adam moments of a model of either package,
    as numpy."""
    def arr(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    out = {"active": arr(model.surfels.active), "step": int(model.adam.step)}
    for name in S.SurfelParams._fields:
        out[f"param_{name}"] = arr(getattr(model.surfels.params, name))
        out[f"mu_{name}"] = arr(getattr(model.adam.mu, name))
        out[f"nu_{name}"] = arr(getattr(model.adam.nu, name))
    return out


def test_submap_rollover_matches_jax(runs):
    js, ps = runs["jax"], runs["port"]
    assert len(ps.local_models) == len(js.local_models) >= 2
    for pm, jm in zip(ps.local_models, js.local_models):
        np.testing.assert_allclose(pm.world_T_model, jm.world_T_model,
                                   atol=1e-6)
        np.testing.assert_allclose(pm.keyframes[0].model_T_frame, np.eye(4),
                                   atol=1e-6)
        assert len(pm.keyframes) == len(jm.keyframes)
    for est, gt in zip(ps.world_T_odom, runs["poses"]):
        np.testing.assert_allclose(est, gt, atol=1e-5)
    assert len(ps.frames) == len(js.frames) == N_FRAMES

    pdir, jdir = runs["port_results"], runs["jax_results"]
    assert (pdir / "odom.txt").read_text() == (jdir / "odom.txt").read_text()
    pg = yaml.safe_load((pdir / "graph.yaml").read_text())
    jg = yaml.safe_load((jdir / "graph.yaml").read_text())
    assert pg["models"] == jg["models"]
    assert len(pg["frames"]) == len(jg["frames"])
    for pf, jf in zip(pg["frames"], jg["frames"]):
        for key in ("id", "timestamp", "model_T_frame", "model_id"):
            assert pf[key] == jf[key], key
        np.testing.assert_allclose(pf["projmatrix"], jf["projmatrix"],
                                   atol=1e-6)
    for i, m in enumerate(ps.local_models):
        xyz = jply.load_surfel_ply(pdir / "models" / f"{i:04d}.ply")[0]
        assert len(xyz) == m.no_gaussians


@pytest.mark.parametrize("who,whose", [("port", "jax"), ("jax", "port"),
                                       ("port", "port")])
def test_checkpoint_resume(runs, who, whose, tmp_path):
    """A checkpoint of either package loads in the other (and the port's
    in the port): the pools come back bitwise, and the resumed run's
    GT-tracked odometry is the uninterrupted run's."""
    slam, restored = runs[f"{who}_from_{whose}"]
    with np.load(runs[f"{whose}_ckpt"] / "model_0000.npz") as d:
        saved = dict(d)
    first = restored[0]
    np.testing.assert_array_equal(first["active"], saved["active"])
    assert first["step"] == int(saved["adam_step"])
    for name in S.SurfelParams._fields:
        for kind in ("param", "mu", "nu"):
            key = f"{kind}_{name}"
            assert first[key].dtype == saved[key].dtype == np.float32
            np.testing.assert_array_equal(first[key], saved[key])

    ref = runs[whose]
    n = N_CKPT + N_RESUMED
    assert len(slam.frames) == len(slam.world_T_odom) == n
    np.testing.assert_allclose(np.stack(slam.world_T_odom),
                               np.stack(ref.world_T_odom[:n]), atol=1e-9)
    assert slam.timestamps == ref.timestamps[:n]
    kf1 = ref.local_models[0].keyframes[0].camera
    kf2 = slam.local_models[0].keyframes[0].camera
    for name in ("depth", "K", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(kf2, name)),
                                      np.asarray(getattr(kf1, name)))
    if who == "port":
        # a keyframe inserted into a restored submap stacks every one of
        # its keyframes, not only the new one
        m = slam.local_models[0]
        assert len(m.keyframes) > 2
        for i, kf in enumerate(m.keyframes):
            np.testing.assert_array_equal(
                m.kf_stack["depth"][i].numpy(),
                kf.camera_in_model().depth.numpy())
        assert slam.local_models[-1].surfels.params.xyz.device.type == "cpu"


# ---------------------------------------------------------------------------
# Mapper repair: densify's sampled mask
# ---------------------------------------------------------------------------

def test_densify_mask_matches_jax():
    """Mapper.update_model keeps densify's sampled mask; under the JAX
    densify's Gumbel noise and on the same pool it is the JAX densify's
    mask, on the initializing update and on the next."""
    h, w, cap = 16, 128, 8192
    d = {"preprocessing": {"image_height": h, "image_width": w,
                           "depth_min": 0.5, "depth_max": 30.0},
         "mapping": {"num_iterations": 3, "densify_percentage": 0.15,
                     "densify_threshold_opacity": 0.5},
         "compute": {"initial_capacity": cap, "rebin_every": 4},
         "logging": {"enable": False}}
    d["compute"]["backend"] = "jnp"
    jcfg = jconfig.from_dict(jconfig.Configuration, d)
    d["compute"]["backend"] = "cuda"
    pcfg = pconfig.from_dict(pconfig.Configuration, d)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.5 * i
        pts = synthetic.sensor_cloud(rng, pose, n=4000)
        arrs = [np.asarray(a) for a in _preprocess_device(
            jnp.asarray(pts), jnp.ones(len(pts), bool), h, w, 0.5, 30.0)]
        frames.append((JFrame(j_make_camera(*arrs), i, model_T_frame=pose),
                       Frame(make_camera(*arrs, device="cpu"), i,
                             model_T_frame=pose)))
    jprogs = jmapper.MapperPrograms(jcfg, h, w, cap)
    pm = mapper.Mapper(pcfg, device="cpu")
    plm = LocalModel(pcfg, device="cpu")
    pm.register_model(plm)
    js, ja = JS.empty_surfels(cap), JS.empty_adam(cap)
    for i, (jfr, pfr) in enumerate(frames):
        key = jax.random.PRNGKey(i)
        js, ja, _, jmask = jprogs._densify(js, ja, jfr.camera_in_model(),
                                           key, initialize=(i == 0))
        jmask = np.asarray(jmask)
        assert jmask.shape == (h, w) and jmask.sum() > 0
        plm.insert_keyframe(pfr)
        pm._gumbel = lambda n: torch.tensor(
            np.asarray(jax.random.gumbel(key, (n,))))
        pm.update_model(pfr, initialize_model=(i == 0))
        np.testing.assert_array_equal(pm._last_densify_mask.numpy(), jmask)
        # the next update starts from the JAX densify's pool
        pool = {k: np.asarray(getattr(js.params, k))
                for k in S.SurfelParams._fields}
        plm.surfels, _ = surfels_from_numpy(pool, np.asarray(js.active),
                                            None, device="cpu")


# ---------------------------------------------------------------------------
# Keyframe trigger
# ---------------------------------------------------------------------------

def test_require_new_keyframe_matches_jax():
    rng = np.random.default_rng(1)
    for tracking in ({"keyframe_threshold_nframes": 3,
                      "keyframe_threshold_fitness": 0.3,
                      "keyframe_threshold_distance": 1.0},
                     {"keyframe_threshold_nframes": -1,
                      "keyframe_threshold_fitness": -1,
                      "keyframe_threshold_distance": 0.5}):
        d = {"tracking": dict(tracking, method="gsaligner"),
             "logging": {"enable": False}}
        jt = JTracker(jconfig.from_dict(jconfig.Configuration, d))
        pt = Tracker(pconfig.from_dict(pconfig.Configuration, d),
                             device="cpu")
        for _ in range(40):
            T = np.eye(4)
            T[:3, 3] = rng.uniform(-1.2, 1.2, 3)
            fit = float(rng.uniform(0.0, 1.0))
            n = int(rng.integers(0, 6))
            for t in (jt, pt):
                t.keyframe_T_frame = T
                t.num_frames_tracked = n
                t.aligner.reg_fitness = fit
            assert pt.require_new_keyframe() == jt.require_new_keyframe()


@pytest.mark.parametrize("writer", ["tum", "kitti"])
def test_trajectory_files_read_back_in_both_packages(tmp_path, writer):
    """The port's writers (rotations re-orthonormalized) read back through
    the port's and the JAX package's readers."""
    from splatloam_tpu.io import trajectory as jtraj
    from splatloam_tpu_torch.io import trajectory
    rng = np.random.default_rng(3)
    poses, stamps = [], []
    for i in range(6):
        q = rng.normal(size=4)
        T = np.eye(4)
        T[:3, :3] = trajectory.rot.rotmat_from_quat(q / np.linalg.norm(q))
        T[:3, 3] = rng.uniform(-5, 5, 3)
        poses.append(T)
        stamps.append(0.1 * i)
    path = tmp_path / f"odom_{writer}.txt"
    kind = pconfig.TrajectoryWriterType(writer)
    trajectory.trajectory_writer_available[kind].write(path, poses, stamps)
    for mod, cfgmod in ((trajectory, pconfig), (jtraj, jconfig)):
        rc = cfgmod.TrajectoryReaderConfig(filename=str(path))
        reader = mod.trajectory_reader_available[
            cfgmod.TrajectoryReaderType(writer)](rc)
        assert len(reader.poses) == len(poses)
        for got, want in zip(reader.poses, poses):
            np.testing.assert_allclose(got, want, atol=1e-4)
        if writer == "tum":
            np.testing.assert_allclose(reader.timestamps, stamps)


# ---------------------------------------------------------------------------
# Debug checks, profiling, data logging
# ---------------------------------------------------------------------------

def test_finite_state_report_masks_padding():
    """Padding rows may hold anything; only active rows are checked, and
    the keys name the leaf as the JAX package does."""
    surf = S.empty_surfels(8, "cpu")
    adam = S.empty_adam(8, "cpu")
    surf.params.xyz[5, 0] = float("nan")
    active = torch.zeros(8, dtype=torch.bool)
    active[0] = True                                   # row 5 inactive
    tree = {"params": surf.params, "adam": adam}
    rep = debug.finite_state_report(tree, active=active)
    assert "['params'].xyz" in rep and "['adam'].mu.quat" in rep
    assert all(v == 0 for v in rep.values())
    debug.assert_finite_state(tree, active=active)      # no raise
    active[5] = True
    rep2 = debug.finite_state_report(tree, active=active)
    assert sum(rep2.values()) == 1
    with pytest.raises(FloatingPointError, match="xyz"):
        debug.assert_finite_state(tree, active=active, what="map")


def test_profiler_count_report_and_trace(tmp_path):
    prof = Profiler(trace_dir=str(tmp_path / "trace"))
    for _ in range(2):
        with prof.phase("a"):
            pass
    prof.count("rays", 100)
    prof.count("rays", 28)
    assert prof.stats["a"].count == 2
    report = prof.report()
    assert "rays" in report and "128" in report and "a " in report
    prof.start_trace()
    torch.ones(4).sum()
    prof.stop_trace()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    off = Profiler(enabled=False)
    with off.phase("a"):
        pass
    assert not off.stats


def test_datalogger_is_the_dummy_or_raises():
    logging_backends.reset_datalogger()
    cfg = pconfig.Configuration()
    cfg.logging.enable = False
    dlog = logging_backends.get_datalogger(cfg)
    assert isinstance(dlog, logging_backends.DataLoggerDummy)
    assert logging_backends.get_datalogger(cfg) is dlog     # singleton
    logging_backends.reset_datalogger()
    cfg.logging.enable = True
    with pytest.raises(NotImplementedError, match="rerun"):
        logging_backends.get_datalogger(cfg)
    logging_backends.reset_datalogger()


@pytest.mark.slow
def test_odometry_mode_end_to_end(tmp_path):
    """The port's run of tests/test_e2e_slam.py's odometry case."""
    logging_backends.reset_datalogger()
    _, cfg = _cfgs(tmp_path, tracking={
        "method": "gsaligner", "keyframe_threshold_nframes": 2,
        "keyframe_threshold_distance": -1,
        "keyframe_threshold_fitness": 0.3})
    poses, clouds = _clouds(4)
    slam = SLAM(cfg, device="cpu")
    _run(slam, Preprocessor(cfg, device="cpu"), poses, clouds, range(4))
    errs = [np.linalg.norm(est[:3, 3] - gt[:3, 3])
            for est, gt in zip(slam.world_T_odom, poses)]
    assert max(errs) < 0.15, f"odometry errors {errs}"
