"""The port's CLI (splatloam_tpu_torch.cli) on the CPU against the JAX
package's: `slam` over tests/test_cli.py's synthetic KITTI layout (GT
tracking, 16x128, 40 iterations) and over the committed VBR bag,
`eval_odom`, `generate_dummy_cfg`, the device rule and one supervised
recovery.  The JAX side runs its CLI in this process, on its jnp
backend, over the same data; the port's config overrides
``compute.backend``, whose values differ between the packages.
"""
import csv
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from splatloam_tpu import cli as jcli
from splatloam_tpu import config as jconfig
from splatloam_tpu.eval import odometry as jodometry
from splatloam_tpu.logging_backends import reset_datalogger as j_reset
from splatloam_tpu_torch import cli
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch.eval import odometry
from splatloam_tpu_torch.io.ply import load_surfel_ply
from splatloam_tpu_torch.profiling import get_profiler
from tests.test_cli import _make_kitti_dataset, _write_cfg

REPO = Path(__file__).resolve().parents[1]
FIX = Path(__file__).parent / "fixtures"
# the packages draw their random numbers apart (tests/test_torch_slam.py),
# so a submap's later densifications, which sample the pixels the
# optimized map leaves uncovered, add a few surfels more or fewer
SURFEL_COUNT_RTOL = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other workers of a parallel test run, torch's intra-op
    thread pool would oversubscribe the cores.  One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.cli, "
            "splatloam_tpu_torch.__main__; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


def _only_dir(folder: Path) -> Path:
    dirs = sorted(folder.iterdir())
    assert len(dirs) == 1, dirs
    return dirs[0]


@pytest.fixture(scope="module")
def kitti_runs(tmp_path_factory):
    """The JAX CLI's and the port's `slam` over one synthetic KITTI
    sequence (4 frames, GT tracking, a keyframe every 2 frames)."""
    tmp = tmp_path_factory.mktemp("kitti_cli")
    seq, gt = _make_kitti_dataset(tmp, np.random.default_rng(0))
    cfg = _write_cfg(tmp, seq, gt)
    j_reset()
    jcli.main(["slam", str(cfg)])
    cli.main(["slam", str(cfg), "--device", "cpu", "compute.backend=auto",
              f"output.folder={tmp / 'port'}"])
    profile = {k: len(v.samples) for k, v in get_profiler().stats.items()}
    return {"jax": _only_dir(tmp / "results"), "port": _only_dir(tmp / "port"),
            "gt": gt, "tmp": tmp, "profile": profile}


def test_slam_cli_matches_jax_cli(kitti_runs):
    jdir, pdir = kitti_runs["jax"], kitti_runs["port"]
    for name in ("cfg.yaml", "odom.txt", "graph.yaml"):
        assert (pdir / name).is_file(), name
    # GT tracking: the same odometry, to the text
    assert (pdir / "odom.txt").read_text() == (jdir / "odom.txt").read_text()
    odom = np.loadtxt(pdir / "odom.txt")
    gt = np.loadtxt(kitti_runs["gt"])
    np.testing.assert_allclose(odom, gt, atol=1e-5)
    assert pconfig.load_configuration(pdir / "cfg.yaml") \
        .compute.backend.value == "auto"

    pg = yaml.safe_load((pdir / "graph.yaml").read_text())
    jg = yaml.safe_load((jdir / "graph.yaml").read_text())
    assert pg["models"] == jg["models"]
    assert len(pg["frames"]) == len(jg["frames"]) == 2
    for pf, jf in zip(pg["frames"], jg["frames"]):
        for key in ("id", "timestamp", "model_T_frame", "model_id"):
            assert pf[key] == jf[key], key
        np.testing.assert_allclose(pf["projmatrix"], jf["projmatrix"],
                                   atol=1e-6)
    # the run's own phase profile: one sample a frame, one a map update
    prof = kitti_runs["profile"]
    assert prof["preprocess"] == prof["process"] == len(odom)
    assert prof["map_update"] == len(pg["frames"])
    for m in pg["models"]:
        n_p = len(load_surfel_ply(pdir / m["filename"])[0])
        n_j = len(load_surfel_ply(jdir / m["filename"])[0])
        assert n_p > 300
        assert abs(n_p - n_j) <= SURFEL_COUNT_RTOL * n_j, (n_p, n_j)


def _perturbed_tum(path: Path, rng, n=40) -> None:
    """ref.txt, a TUM trajectory along a curve at 10 Hz, and est.txt, its
    noisy copy stamped 2 ms later."""
    t = 0.1 * np.arange(n)
    ref, est = [], []
    for i in range(n):
        T = np.eye(4)
        c, s = np.cos(0.05 * i), np.sin(0.05 * i)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [np.sin(0.1 * i) * 5, 0.5 * i, 0.02 * i]
        ref.append(T)
        E = T.copy()
        E[:3, 3] += rng.normal(scale=0.05, size=3)
        est.append(E)
    from splatloam_tpu_torch.io.trajectory import TrajectoryWriter_TUM
    TrajectoryWriter_TUM.write(path / "ref.txt", ref, t)
    TrajectoryWriter_TUM.write(path / "est.txt", est, t + 0.002)


def test_evaluate_rpe_matches_jax():
    rng = np.random.default_rng(3)
    ref, est = [], []
    for i in range(60):
        T = np.eye(4)
        T[:3, 3] = [i * 0.7, np.sin(0.2 * i), 0.0]
        ref.append(T)
        E = T.copy()
        E[:3, 3] += rng.normal(scale=0.03, size=3)
        est.append(E)
    t = list(0.1 * np.arange(60))
    t_est = [x + rng.uniform(-0.01, 0.01) for x in t]
    for kw in ({"is_kitti": True},
               {"timestamps": t_est, "gt_timestamps": t}):
        mean_p, std_p = odometry.evaluate_rpe(est, ref, **kw)
        mean_j, std_j = jodometry.evaluate_rpe(est, ref, **kw)
        assert mean_p > 0
        np.testing.assert_allclose([mean_p, std_p], [mean_j, std_j],
                                   rtol=1e-9)


def _rpe(out: str) -> float:
    return float(out.split("RPE=")[1].split()[0])


@pytest.mark.parametrize("case", ["results_dir", "tum_files"])
def test_eval_odom_matches_jax(case, kitti_runs, tmp_path, capsys):
    """The port's eval_odom prints JAX's RPE (rtol 1e-9) and writes the
    same CSV; on the SLAM results (KITTI, index-aligned) and on TUM files
    matched by timestamp."""
    if case == "results_dir":
        argv = [str(kitti_runs["port"])]
    else:
        _perturbed_tum(tmp_path, np.random.default_rng(5))
        argv = [str(tmp_path / "est.txt"), "--reference",
                str(tmp_path / "ref.txt"), "--estimate-format", "tum",
                "--reference-format", "tum"]
    rows, rpes = {}, {}
    for who, main in (("jax", jcli.main), ("port", cli.main)):
        out = tmp_path / f"{who}.csv"
        main(["eval_odom", *argv, "--output", str(out)])
        rpes[who] = _rpe(capsys.readouterr().out)
        with open(out) as f:
            rows[who] = list(csv.reader(f))
    assert rows["port"] == rows["jax"]
    assert rows["port"][0] == ["estimate", "reference", "rpe-mean",
                               "rpe-stdev"]
    mean = float(rows["port"][1][2])
    assert np.isfinite(mean)
    np.testing.assert_allclose(rpes["port"], rpes["jax"], rtol=1e-9)
    if case == "results_dir":
        assert mean < 1e-3       # GT tracking: the exact trajectory
    else:
        assert mean > 1e-3


# the largest spread of each frame's position on the bag over mapper
# seeds 0-5, the larger of the two packages' (tools/bag_seed_spread.py:
# port 0, .053, .079, .055, .104, .165 m; JAX 0, .037, .089, .054, .153,
# .164 m), rounded up to the millimetre
BAG_SEED_SPREAD_M = np.array([0.0, 0.053, 0.089, 0.055, 0.154, 0.166])


def _bag_odom(main, tmp: Path, *argv) -> np.ndarray:
    """`slam` over the committed bag with chip_smoke.VBR_CFG
    (tests/test_cli_vendor.py's configuration) -> its TUM odom rows."""
    cfg = tmp / "cfg.yaml"
    tmp.mkdir()
    cfg.write_text(chip_smoke.VBR_CFG.format(bag=FIX / "vbr_seq.bag",
                                             out=tmp / "results"))
    main(["slam", str(cfg), *argv])
    rdir = _only_dir(tmp / "results")
    for artifact in ("cfg.yaml", "odom.txt", "graph.yaml"):
        assert (rdir / artifact).is_file(), artifact
    return np.loadtxt(rdir / "odom.txt", ndmin=2)


def test_slam_cli_over_committed_bag(tmp_path):
    """The port's run of tests/test_cli_vendor.py: 6 messages of the
    committed LZ4 ROS1 bag through the VBR reader and the gsaligner
    tracker, under the same gates, and each frame's position within the
    packages' seed-to-seed spread of the JAX CLI's run of the same bag
    (its jnp backend)."""
    rows = _bag_odom(cli.main, tmp_path / "port", "--device", "cpu")
    assert rows.shape == (6, 8), rows
    assert rows[-1, 1] > 0.5, rows[:, 1]
    assert np.isfinite(rows).all()
    j_reset()
    jrows = _bag_odom(jcli.main, tmp_path / "jax", "compute.backend=jnp")
    np.testing.assert_array_equal(rows[:, 0], jrows[:, 0])   # the stamps
    dist = np.linalg.norm(rows[:, 1:4] - jrows[:, 1:4], axis=1)
    assert (dist <= BAG_SEED_SPREAD_M).all(), (dist, BAG_SEED_SPREAD_M)


def test_generate_dummy_cfg(tmp_path):
    out = tmp_path / "dummy.yaml"
    cli.main(["generate_dummy_cfg", str(out)])
    pcfg = pconfig.load_configuration(out)
    jcfg = jconfig.load_configuration(out)
    assert pcfg.mapping.num_iterations == 500
    assert pconfig.to_dict(pcfg) == jconfig.to_dict(jcfg)


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_slam_without_device_raises(kitti_runs, monkeypatch):
    _no_gpu(monkeypatch)
    cfg = kitti_runs["tmp"] / "cfg.yaml"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["slam", str(cfg), "compute.backend=auto"])


def test_yaml_device_cpu_does_not_move_the_run(kitti_runs, tmp_path,
                                               monkeypatch):
    """The config's ``device:`` field is ignored: only --device picks the
    CPU."""
    _no_gpu(monkeypatch)
    cfg = tmp_path / "cpu.yaml"
    d = yaml.safe_load((kitti_runs["tmp"] / "cfg.yaml").read_text())
    d["device"] = "cpu"
    d["compute"]["backend"] = "auto"
    cfg.write_text(yaml.safe_dump(d))
    assert pconfig.load_configuration(cfg).device == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["slam", str(cfg)])


def test_module_entry_point_needs_a_device(kitti_runs):
    """`python -m splatloam_tpu_torch slam <cfg>` without --device fails
    where no GPU is present."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    r = subprocess.run(
        [sys.executable, "-m", "splatloam_tpu_torch", "slam",
         str(kitti_runs["tmp"] / "cfg.yaml"), "compute.backend=auto"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_supervised_recovery(tmp_path, monkeypatch, capfd):
    """`slam --supervise`: the child dies at frame 2, after the keyframe
    of frame 1 (0.4 m from frame 0) was checkpointed with frame 0
    processed; a new child resumes from the checkpoint at frame 1 and
    completes the 4-frame run."""
    seq, gt = _make_kitti_dataset(tmp_path, np.random.default_rng(0),
                                  n_frames=4)
    cfg = _write_cfg(tmp_path, seq, gt)
    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SPLATLOAM_FAULT_AT_FRAME", "2")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cli.main(["slam", str(cfg), "--supervise", "--device", "cpu",
              "compute.backend=auto", "mapping.num_iterations=10",
              "tracking.keyframe_threshold_distance=0.3",
              f"output.checkpoint_dir={ckpt}",
              "output.checkpoint_every_keyframes=1"])
    assert (ckpt / ".fault_injected").exists()
    log = re.sub(r"\s+", " ", "".join(capfd.readouterr()))
    starts = [int(n) for n in
              re.findall(r"attempt \d+ \(checkpoint at frame (\d+)", log)]
    assert starts == [0, 1], log[-2000:]
    odom = np.loadtxt(_only_dir(tmp_path / "results") / "odom.txt")
    np.testing.assert_allclose(odom, np.loadtxt(gt), atol=1e-5)
