"""The port's data loggers (splatloam_tpu_torch.logging_backends): the
dummy, the tensorboard writer, and rerun against tests/
test_rerun_backend.py's spec-shaped fake module (the rerun-sdk is not
installed here), fed tensors as the SLAM loop feeds them.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch import logging_backends
from splatloam_tpu_torch.logging_backends import (DataLoggerDummy,
                                                  get_datalogger,
                                                  reset_datalogger)
from splatloam_tpu_torch.model import surfels as S
from tests.test_rerun_backend import _make_fake_rerun, _Recorder

RR_MODULE = "splatloam_tpu_torch.logging_backends.rerun_logging"


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.logging_backends; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _cfg(**logging):
    return pconfig.from_dict(pconfig.Configuration, {"logging": logging})


@pytest.fixture
def fake_rerun(monkeypatch):
    rec = _Recorder()
    rr, bp = _make_fake_rerun(rec)
    monkeypatch.setitem(sys.modules, "rerun", rr)
    monkeypatch.setitem(sys.modules, "rerun.blueprint", bp)
    # the module binds `import rerun as rr` at import time: reload it
    sys.modules.pop(RR_MODULE, None)
    reset_datalogger()
    yield rec
    sys.modules.pop(RR_MODULE, None)
    reset_datalogger()


def _pool(n_new=3, capacity=16):
    surf, adam = S.empty_surfels(capacity, "cpu"), S.empty_adam(capacity,
                                                                 "cpu")
    rng = np.random.default_rng(1)
    newp = S.SurfelParams(
        xyz=torch.tensor(rng.random((n_new, 3)), dtype=torch.float32),
        log_scale=torch.full((n_new, 2), -2.0),
        quat=torch.tensor([[1.0, 0.0, 0.0, 0.0]] * n_new),
        logit_opacity=torch.full((n_new,), 1.0))
    return S.insert_surfels(surf, adam, newp, torch.tensor(n_new))[0]


def test_dummy_logger_by_default():
    reset_datalogger()
    assert isinstance(get_datalogger(_cfg(enable=False)), DataLoggerDummy)
    reset_datalogger()


def test_tensorboard_backend_logs(tmp_path):
    reset_datalogger()
    cfg = pconfig.from_dict(pconfig.Configuration, {
        "logging": {"enable": True, "logger_type": "tensorboard"},
        "output": {"folder": str(tmp_path / "out"), "writer": "tum"}})
    dlog = get_datalogger(cfg)
    from splatloam_tpu_torch.logging_backends.tensorboard_logging import \
        DataLoggerTB
    assert isinstance(dlog, DataLoggerTB)
    dlog.set_timestamp(1.5)
    dlog.log_depth_image("frame/depth", torch.rand(8, 16))
    dlog.log_image("frame/normals", np.random.rand(8, 16, 3))
    dlog.log_transform("world/model", torch.eye(4, dtype=torch.float64))
    dlog.log_scalar("loss", torch.tensor(0.5))
    dlog.log_pointcloud("cloud", torch.zeros((10, 3)))
    dlog.log_model("world/model", _pool())
    dlog.writer.flush()
    events = list((tmp_path / "out" / "tensorboard").glob("events.*"))
    assert events, "no tensorboard event files written"
    reset_datalogger()


def test_rerun_backend_full_surface(fake_rerun):
    from splatloam_tpu_torch.logging_backends.rerun_logging import \
        DataLoggerRR

    lg = DataLoggerRR(_cfg(rerun_spawn=True))
    names = [c[0] for c in fake_rerun.calls]
    assert names[:3] == ["init", "send_blueprint", "spawn"]

    lg.set_timestamp(1.25)
    lg.log_image("frame/depth_in", torch.rand(4, 8))
    lg.log_depth_image("frame/depth", torch.ones(4, 8))
    lg.log_pointcloud("world/scan", torch.zeros((5, 3)))
    lg.log_scalar("loss", 0.25)
    T = np.eye(4)
    T[:3, 3] = (1, 2, 3)
    lg.log_transform("world/frame", T)
    lg.log_model("world/model", _pool())

    names = [c[0] for c in fake_rerun.calls]
    assert names.count("log") == 6   # image/depth/cloud/scalar/transform + model
    assert names.count("set_time") == 1
    ell = fake_rerun.calls[-1][1][1]
    assert ell.n == 3
    n_before = len(fake_rerun.calls)
    lg.log_model("world/model", S.empty_surfels(8, "cpu"))   # empty: no log
    assert len(fake_rerun.calls) == n_before


def test_rerun_backend_grpc_modes(fake_rerun):
    from splatloam_tpu_torch.logging_backends.rerun_logging import \
        DataLoggerRR

    DataLoggerRR(_cfg(rerun_spawn=False, rerun_serve_grpc=True))
    assert "serve_grpc" in [c[0] for c in fake_rerun.calls]
    fake_rerun.calls.clear()
    DataLoggerRR(_cfg(rerun_spawn=False,
                      rerun_connect_grpc_url="rerun+http://127.0.0.1:9876"))
    kinds = [c[0] for c in fake_rerun.calls]
    assert "connect_grpc" in kinds and "spawn" not in kinds


def test_get_datalogger_builds_rerun(fake_rerun):
    from splatloam_tpu_torch.logging_backends.rerun_logging import \
        DataLoggerRR
    dlog = get_datalogger(_cfg(enable=True, logger_type="rerun"))
    assert isinstance(dlog, DataLoggerRR)
    assert get_datalogger(None) is dlog                   # singleton


def test_rerun_missing_falls_back_to_the_dummy(monkeypatch):
    monkeypatch.setitem(sys.modules, "rerun", None)      # import fails
    sys.modules.pop(RR_MODULE, None)
    reset_datalogger()
    assert isinstance(get_datalogger(_cfg(enable=True, logger_type="rerun")),
                      DataLoggerDummy)
    reset_datalogger()
    sys.modules.pop(RR_MODULE, None)


def test_to_numpy_reads_tensors_back():
    t = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(logging_backends.to_numpy(t), t.numpy())
    np.testing.assert_array_equal(logging_backends.to_numpy([1, 2]), [1, 2])


# --- the port's loggers against the JAX package's, on the same inputs -----

JRR_MODULE = "splatloam_tpu.logging_backends.rerun_logging"


def _keeping_rerun(rec):
    """tests/test_rerun_backend.py's fake rerun, each archetype also
    keeping every argument it was given (as ``given``)."""
    rr, bp = _make_fake_rerun(rec)
    for name in ("Image", "DepthImage", "Points3D", "Scalars", "Quaternion",
                 "Transform3D", "Ellipsoids3D"):
        base = getattr(rr, name)

        def init(self, *a, _base=base, **k):
            _base.__init__(self, *a, **k)
            self.given = (a, k)
        setattr(rr, name, type(name, (base,), {"__init__": init}))
    return rr, bp


def _plain(x):
    """A recorded call as nested dicts and tuples of numpy arrays and
    strings; an object as its class name and attributes."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if x is None or isinstance(x, str):
        return x
    if hasattr(x, "__dict__"):
        return (type(x).__name__, _plain(vars(x)))
    arr = np.asarray(x)
    assert arr.dtype != object, type(x)
    return arr


def _assert_same(p, j, path="call"):
    """Equal structure, dtypes, shapes and values."""
    assert type(p) is type(j), (path, type(p), type(j))
    if isinstance(p, dict):
        assert p.keys() == j.keys(), (path, p.keys(), j.keys())
        for k in p:
            _assert_same(p[k], j[k], f"{path}.{k}")
    elif isinstance(p, tuple):
        assert len(p) == len(j), (path, len(p), len(j))
        for i, (a, b) in enumerate(zip(p, j)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(p, np.ndarray):
        assert (p.dtype, p.shape) == (j.dtype, j.shape), (path, p.dtype,
                                                          j.dtype)
        np.testing.assert_array_equal(p, j, err_msg=path)
    else:
        assert p == j, (path, p, j)


def _inputs():
    """One pool (active rows between inactive ones, random rotations) and
    the images, transform, cloud and scalar the SLAM loop logs."""
    rng = np.random.default_rng(7)
    cap, active = 12, np.zeros(12, bool)
    active[[0, 3, 4, 8, 11]] = True
    q = rng.normal(size=(cap, 4)).astype(np.float32)
    pool = {"xyz": rng.normal(size=(cap, 3)).astype(np.float32),
            "log_scale": rng.uniform(-4, -1, (cap, 2)).astype(np.float32),
            "quat": q / np.linalg.norm(q, axis=1, keepdims=True),
            "logit_opacity": rng.normal(size=cap).astype(np.float32),
            "active": active}
    depth = rng.uniform(0.5, 40.0, (6, 10))
    depth[1, 2] = np.nan
    T = np.eye(4)
    T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T[:3, 3] = rng.normal(size=3)
    return {"pool": pool, "depth": depth,
            "image": rng.random((6, 10)), "normals": rng.random((6, 10, 3)),
            "mask": rng.random((6, 10, 1)) > 0.5, "T": T,
            "cloud": rng.normal(size=(9, 3)).astype(np.float32),
            "scalar": 0.375}


def _jax_pool(d):
    import jax.numpy as jnp
    from splatloam_tpu.model import surfels as JS
    return JS.Surfels(JS.SurfelParams(
        *(jnp.asarray(d[k]) for k in JS.SurfelParams._fields)),
        jnp.asarray(d["active"]))


def _port_pool(d):
    return S.Surfels(S.SurfelParams(
        *(torch.from_numpy(d[k]) for k in S.SurfelParams._fields)),
        torch.from_numpy(d["active"]))


def _drive(lg, x, pool, as_input):
    """The calls SLAM.process and Mapper make on a data logger."""
    lg.set_timestamp(2.5)
    lg.log_image("frame/normals", as_input(x["normals"]))
    lg.log_image("frame/densify_mask",
                 as_input(x["mask"][..., 0].astype(np.float32)))
    lg.log_depth_image("frame/depth_in", as_input(x["depth"]))
    lg.log_depth_image("frame/depth_l1", as_input(x["image"]))
    lg.log_pointcloud("world/model/keyframe/frame", as_input(x["cloud"]))
    lg.log_transform("world/model", as_input(x["T"]))
    lg.log_scalar("loss", as_input(np.asarray(x["scalar"])))
    lg.log_model("world/model", pool)


def _rerun_calls(monkeypatch, module, pool, as_input):
    rec = _Recorder()
    rr, bp = _keeping_rerun(rec)
    monkeypatch.setitem(sys.modules, "rerun", rr)
    monkeypatch.setitem(sys.modules, "rerun.blueprint", bp)
    sys.modules.pop(module, None)         # binds `import rerun as rr`
    import importlib
    mod = importlib.import_module(module)
    _drive(mod.DataLoggerRR(_cfg(rerun_spawn=True)), _inputs(), pool,
           as_input)
    sys.modules.pop(module, None)
    return _plain(rec.calls)


def test_rerun_logger_matches_jax(monkeypatch):
    """Every argument the port's DataLoggerRR hands rerun (image bytes,
    depth images, ellipsoid centers, half sizes, xyzw quaternions and
    normal colours, transforms, blueprint) is the JAX logger's, exactly
    (the colours come from each package's quat_to_rotmat in float32)."""
    x = _inputs()
    jcalls = _rerun_calls(monkeypatch, JRR_MODULE, _jax_pool(x["pool"]),
                          lambda a: a)
    pcalls = _rerun_calls(monkeypatch, RR_MODULE, _port_pool(x["pool"]),
                          torch.from_numpy)
    assert [c[0] for c in pcalls].count("log") == 8
    ell = pcalls[-1][1][1][1]["given"][1]
    assert ell["centers"].shape == (5, 3)
    _assert_same(pcalls, jcalls)


class _FakeWriter:
    """SummaryWriter's surface that DataLoggerTB uses, recording calls."""

    def __init__(self, log_dir=None):
        self.calls = [("init", log_dir)]

    def add_scalar(self, tag, value, step):
        self.calls.append(("add_scalar", tag, value, step))

    def add_image(self, tag, image, step):
        self.calls.append(("add_image", tag, image, step))


def test_tensorboard_logger_matches_jax(monkeypatch, tmp_path):
    """The port's DataLoggerTB writes the JAX logger's scalars and its
    min/max-normalised images (NaN to 0, channels first), exactly."""
    from splatloam_tpu.logging_backends import tensorboard_logging as jtb
    from splatloam_tpu_torch.logging_backends import \
        tensorboard_logging as ptb
    x = _inputs()
    cfg = pconfig.from_dict(pconfig.Configuration,
                            {"output": {"folder": str(tmp_path)}})
    calls = {}
    for who, mod, pool, as_input in (
            ("jax", jtb, _jax_pool(x["pool"]), lambda a: a),
            ("port", ptb, _port_pool(x["pool"]), torch.from_numpy)):
        monkeypatch.setattr(mod, "SummaryWriter", _FakeWriter)
        lg = mod.DataLoggerTB(cfg)
        _drive(lg, x, pool, as_input)
        calls[who] = _plain(lg.writer.calls)
    images = [c for c in calls["port"] if c[0] == "add_image"]
    assert len(images) == 4 and images[0][2].shape == (3, 6, 10)
    assert np.isfinite(images[2][2]).all()               # the NaN depth
    n_surfels = [c[2] for c in calls["port"]
                 if c[:2] == ("add_scalar", "world/model/num_surfels")]
    assert n_surfels == [5]
    _assert_same(calls["port"], calls["jax"])
