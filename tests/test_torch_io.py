"""The port's readers (splatloam_tpu_torch.io: native, pointcloud, rosbag,
datasets) against the JAX package's on the committed vendor-byte fixtures
(tests/fixtures, written by tools/make_fixtures.py) and on synthetic
dataset layouts: the arrays must be equal (atol 0), and equal to
tests/fixtures/expected.npz.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from splatloam_tpu import config as jconfig
from splatloam_tpu.io import datasets as jdatasets
from splatloam_tpu.io import native as jnative
from splatloam_tpu.io import pointcloud as jpointcloud
from splatloam_tpu.io import rosbag as jrosbag
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch.io import datasets, native, pointcloud, rosbag

FIX = Path(__file__).parent / "fixtures"
EXP = np.load(FIX / "expected.npz")
PACKAGES = {"jax": (jconfig, jpointcloud, jrosbag, jdatasets),
            "port": (pconfig, pointcloud, rosbag, datasets)}


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
            "splatloam_tpu_torch.io.datasets, "
            "splatloam_tpu_torch.io.native, "
            "splatloam_tpu_torch.io.pointcloud, "
            "splatloam_tpu_torch.io.rosbag, "
            "splatloam_tpu_torch.eval.odometry, "
            "splatloam_tpu_torch.debug; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_port_sources_import_no_jax():
    """No module of the port names jax or the JAX package in an import
    (torch.utils.tensorboard may pull jax in through tensorflow where
    both are installed; the port's own code never does)."""
    import ast
    root = Path(__file__).resolve().parents[1] / "splatloam_tpu_torch"
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "splatloam_tpu"), \
                    f"{path}: imports {name}"


def _both(fn):
    """fn(package modules) for both packages -> (jax result, port result)."""
    return fn(*PACKAGES["jax"]), fn(*PACKAGES["port"])


def _assert_msgs_equal(msgs_j, msgs_p, n):
    assert len(msgs_j) == len(msgs_p) == n
    for (xj, tj), (xp, tp) in zip(msgs_j, msgs_p):
        assert xp.dtype == xj.dtype == np.float32
        np.testing.assert_array_equal(xp, xj)
        assert tp == tj


def test_kitti_bin_fixture(tmp_path):
    d = tmp_path / "velodyne"
    d.mkdir()
    shutil.copy(FIX / "kitti_0000000000.bin", d / "0000000000.bin")
    (tmp_path / "times.txt").write_text("0.0\n")

    def read(cfgm, pc, *_):
        cfg = cfgm.PointCloudReaderConfig(
            cloud_folder=str(d),
            timestamp_filename=str(tmp_path / "times.txt"))
        return list(pc.PointCloudReader_BIN(cfg))

    msgs_j, msgs_p = _both(read)
    _assert_msgs_equal(msgs_j, msgs_p, 1)
    np.testing.assert_array_equal(msgs_p[0][0], EXP["kitti_xyz"])


def test_pcd_lzf_fixture():
    xyz_j, xyz_p = _both(lambda c, pc, *_: pc.read_pcd(FIX / "ouster_lzf.pcd"))
    np.testing.assert_array_equal(xyz_p, xyz_j)
    np.testing.assert_array_equal(xyz_p, EXP["bag_xyz_0"])


@pytest.mark.parametrize("name,topic", [
    ("ouster_lz4.bag", "/ouster/points"),
    ("ouster_bz2.bag", "/ouster/points"),
    ("hesai.db3", "/hesai/pandar"),
    ("ouster.mcap", "/ouster/points")])
def test_bag_fixtures(name, topic):
    msgs_j, msgs_p = _both(
        lambda c, pc, rb, ds: list(rb.BagSequenceReader([FIX / name], topic)))
    _assert_msgs_equal(msgs_j, msgs_p, 3)
    for i, (xyz, ts) in enumerate(msgs_p):
        np.testing.assert_array_equal(xyz, EXP[f"bag_xyz_{i}"])
        assert abs(ts - EXP["bag_t"][i]) < 1e-6


def test_vbr_sequence_bag():
    def read(c, pc, rb, ds):
        reader = rb.BagSequenceReader([FIX / "vbr_seq.bag"], "/ouster/points")
        return reader.message_count, list(reader)

    (n_j, msgs_j), (n_p, msgs_p) = _both(read)
    assert n_j == n_p == 6
    _assert_msgs_equal(msgs_j, msgs_p, 6)
    np.testing.assert_allclose([t for _, t in msgs_p], EXP["seq_t"], atol=1e-6)
    assert [len(x) for x, _ in msgs_p] == list(EXP["seq_n"])


def _lzf_literals(payload: bytes) -> bytes:
    """A literal-only LZF stream (valid, uncompressed)."""
    out = b""
    for i in range(0, len(payload), 32):
        run = payload[i:i + 32]
        out += bytes([len(run) - 1]) + run
    return out


def _lz4_frame_stored(payload: bytes) -> bytes:
    """An LZ4 frame holding ``payload`` as one stored block."""
    import struct
    head = struct.pack("<I", 0x184D2204) + bytes([0x40, 0x40, 0x00])
    return (head + struct.pack("<I", 0x80000000 | len(payload)) + payload
            + struct.pack("<I", 0))


@pytest.mark.parametrize("what", ["lzf", "lz4", "files", "filter", "pcd",
                                  "lz4_bag"])
def test_native_and_fallback_give_the_same_bytes(what, tmp_path, monkeypatch):
    """The native library's path (when it loads; a test may not assert
    that it does) and the pure-Python fallback give the same bytes, in
    both packages."""
    rng = np.random.default_rng(0)
    payload = bytes(rng.integers(0, 4, 3000, dtype=np.uint8))
    paths = []
    for k in range(5):
        paths.append(tmp_path / f"{k}.bin")
        paths[-1].write_bytes(bytes([k + 1]) * (40 + 9 * k))
    xyzi = (rng.normal(size=(2000, 4)) * 10).astype(np.float32)
    xyzi[7, 0], xyzi[9, 1] = np.nan, np.inf

    def run(nat, pc, rb):
        if what == "lzf":
            return nat.lzf_decompress(_lzf_literals(payload), len(payload))
        if what == "lz4":
            return nat.lz4_frame_decompress(_lz4_frame_stored(payload),
                                            len(payload))
        if what == "files":
            buf, sizes = nat.read_files_batch(paths, stride=96)
            return buf.tobytes() + sizes.tobytes()
        if what == "filter":
            return nat.filter_cloud(xyzi, 2.0, 25.0).tobytes()
        if what == "pcd":
            return pc.read_pcd(FIX / "ouster_lzf.pcd").tobytes()
        return b"".join(x.tobytes() for x, _ in rb.BagSequenceReader(
            [FIX / "ouster_lz4.bag"], "/ouster/points"))

    active = {"jax": run(jnative, jpointcloud, jrosbag),
              "port": run(native, pointcloud, rosbag)}
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    fallback = {"jax": run(jnative, jpointcloud, jrosbag),
                "port": run(native, pointcloud, rosbag)}
    assert active["port"] == fallback["port"] == active["jax"] == \
        fallback["jax"]
    if what in ("lzf", "lz4"):
        assert active["port"] == payload


# ---------------------------------------------------------------------------
# dataset readers: (cloud, timestamp, pose) triples of both packages
# ---------------------------------------------------------------------------

CALIB_TR = np.array([[0.0, -1.0, 0.0, 0.1],
                     [0.0, 0.0, -1.0, -0.2],
                     [1.0, 0.0, 0.0, 0.3]])


def _rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _poses(n):
    out = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = _rot(0.1 * i)
        T[:3, 3] = [0.4 * i, 0.05 * i, 0.01 * i]
        out.append(T)
    return out


def _write_tum(path, stamps, poses):
    from scipy.spatial.transform import Rotation
    with open(path, "w") as f:
        f.write("#timestamp tx ty tz qx qy qz qw\n")
        for t, T in zip(stamps, poses):
            q = Rotation.from_matrix(T[:3, :3]).as_quat()
            f.write(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in
                                           [*T[:3, 3], *q]) + "\n")


def _kitti_layout(tmp_path, n=4):
    """velodyne/*.bin (xyzi), times.txt, calib.txt with a non-identity
    ``Tr:``, poses.txt."""
    seq = tmp_path / "seq"
    (seq / "velodyne").mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(n):
        rng.normal(size=(300 + 10 * i, 4)).astype("<f4").tofile(
            seq / "velodyne" / f"{i:06d}.bin")
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.6f}\n"
                                           for i in range(n)))
    (seq / "calib.txt").write_text(
        "P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: "
        + " ".join(f"{v:.6f}" for v in CALIB_TR.reshape(-1)) + "\n")
    gt = tmp_path / "poses.txt"
    gt.write_text("".join(" ".join(f"{v:.9f}" for v in T[:3].reshape(-1))
                          + "\n" for T in _poses(n)))
    return seq, gt


def _dataset_case(kind, tmp_path):
    """(config dict, number of triples) of each dataset reader."""
    if kind == "kitti":
        seq, gt = _kitti_layout(tmp_path)
        return {"dataset_type": "kitti",
                "cloud_reader": {"cloud_folder": str(seq)},
                "trajectory_reader": {"filename": str(gt)}}, 4
    if kind == "generic":
        seq, _ = _kitti_layout(tmp_path)
        tum = tmp_path / "gt.tum"
        _write_tum(tum, [0.1 * i for i in range(4)], _poses(4))
        return {"dataset_type": "generic",
                "cloud_reader": {
                    "cloud_folder": str(seq / "velodyne"),
                    "cloud_format": "bin",
                    "timestamp_filename": str(seq / "times.txt")},
                "trajectory_reader": {
                    "reader_type": "tum", "filename": str(tum),
                    "gt_T_sensor_kitti_filename": str(seq / "calib.txt")}}, 4
    if kind == "oxspires_vilens":
        folder = tmp_path / "pcd"
        folder.mkdir()
        stamps = [(1700000000 + i, 250_000_000 * i) for i in range(3)]
        for s, ns in stamps:
            shutil.copy(FIX / "ouster_lzf.pcd", folder / f"cloud_{s}_{ns}.pcd")
        csv = tmp_path / "vilens.csv"
        with open(csv, "w") as f:
            f.write("# counter, sec, nsec, x, y, z, qx, qy, qz, qw\n")
            for k, ((s, ns), T) in enumerate(zip(stamps, _poses(3))):
                from scipy.spatial.transform import Rotation
                q = Rotation.from_matrix(T[:3, :3]).as_quat()
                f.write(", ".join([str(k), str(s), str(ns)]
                                  + [f"{v:.9f}" for v in [*T[:3, 3], *q]])
                        + "\n")
        return {"dataset_type": "oxspires_vilens",
                "cloud_reader": {"cloud_folder": str(folder)},
                "trajectory_reader": {"filename": str(csv)}}, 3
    bag, topic, n = {
        "vbr": ("vbr_seq.bag", None, 6),
        "ncd": ("ouster_bz2.bag", "/ouster/points", 3),
        "oxspires": ("hesai.db3", None, 3)}[kind]
    stamps = EXP["seq_t"] if kind == "vbr" else EXP["bag_t"]
    tum = tmp_path / "gt.tum"
    _write_tum(tum, stamps, _poses(n))
    return {"dataset_type": kind,
            "cloud_reader": {"cloud_folder": str(FIX / bag),
                             "rosbag_topic": topic},
            "trajectory_reader": {"filename": str(tum)},
            "skip_clouds_wno_sync": True}, n


def _triples(cfgm, ds, data):
    cfg = cfgm.from_dict(cfgm.Configuration, {"data": data})
    reader = ds.get_dataset_reader(cfg)
    n = len(reader)
    return n, list(reader)


@pytest.mark.parametrize("kind", ["kitti", "generic", "vbr", "ncd",
                                  "oxspires", "oxspires_vilens"])
def test_dataset_reader_triples(kind, tmp_path):
    data, n = _dataset_case(kind, tmp_path)
    (n_j, trip_j), (n_p, trip_p) = _both(
        lambda c, pc, rb, ds: _triples(c, ds, data))
    assert n_j == n_p == len(trip_j) == len(trip_p) == n
    for (cj, tj, Tj), (cp, tp, Tp) in zip(trip_j, trip_p):
        np.testing.assert_array_equal(cp, cj)
        assert tp == tj
        np.testing.assert_array_equal(Tp, Tj)
    if kind == "kitti":
        # index-aligned poses, times.txt stamps, the calib's Tr applied
        calib = np.vstack([CALIB_TR, [0, 0, 0, 1]])
        for i, (_, t, T) in enumerate(trip_p):
            assert t == pytest.approx(0.1 * i)
            np.testing.assert_allclose(T, _poses(4)[i] @ calib, atol=1e-8)
    assert not np.allclose(trip_p[-1][2], np.eye(4))


@pytest.mark.parametrize("skip", [True, False])
def test_sync_skip_rule(skip, tmp_path):
    """A cloud without a pose within timestamp_dtol is skipped
    (skip_clouds_wno_sync) or given the identity, in both packages."""
    tum = tmp_path / "gt.tum"
    keep = [0, 2, 3, 5]
    _write_tum(tum, EXP["seq_t"][keep], [_poses(6)[i] for i in keep])
    data = {"dataset_type": "vbr",
            "cloud_reader": {"cloud_folder": str(FIX / "vbr_seq.bag")},
            "trajectory_reader": {"filename": str(tum)},
            "skip_clouds_wno_sync": skip}
    (_, trip_j), (_, trip_p) = _both(
        lambda c, pc, rb, ds: _triples(c, ds, data))
    stamps = [t for _, t, _ in trip_p]
    assert stamps == [t for _, t, _ in trip_j]
    for (cj, _, Tj), (cp, _, Tp) in zip(trip_j, trip_p):
        np.testing.assert_array_equal(cp, cj)
        np.testing.assert_array_equal(Tp, Tj)
    if skip:
        np.testing.assert_allclose(stamps, EXP["seq_t"][keep], atol=1e-6)
    else:
        assert len(trip_p) == 6
        for i in (1, 4):
            np.testing.assert_array_equal(trip_p[i][2], np.eye(4))
        np.testing.assert_allclose(trip_p[5][2], _poses(6)[5], atol=1e-6)
