"""The port's meshing and reconstruction commands against the JAX
package's, on the CPU, on one results directory.

The directory comes from the port's SLAM at tests/test_e2e_slam.py's
scale (5 frames of the synthetic world, GT tracking, 60 iterations) with
``compute.backend: auto``, which both packages load (the port's tiled
kernel path, each kernel's plain version here; JAX's jnp renderer on the
CPU).  ``render_graph_points`` is held to JAX's per point; the CLI's
``mesh`` (TSDF and grid Poisson), ``eval_recon`` and ``crop_recon`` are
run from both packages' ``main`` in this process.  Two meshes are
compared by the recon metrics between them, not vertex by vertex.
"""
import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import synthetic
from splatloam_tpu import cli as jcli
from splatloam_tpu import config as jconfig
from splatloam_tpu import postprocessing as jpost
from splatloam_tpu.eval import recon as jrecon
from splatloam_tpu_torch import cli
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch import postprocessing as post
from splatloam_tpu_torch.eval.recon import evaluate_recon, load_mesh
from splatloam_tpu_torch.io.ply import read_ply, write_ply
from splatloam_tpu_torch.logging_backends import reset_datalogger
from splatloam_tpu_torch.preprocessing import Preprocessor
from splatloam_tpu_torch.slam import SLAM

REPO = Path(__file__).resolve().parents[1]
# points of render_graph_points: the kernel path against the golden jnp
# renderer through a depth of ~10 m (depth sums 2e-4 per unit alpha)
POINT_ATOL = 2e-3
NORMAL_ATOL = 2e-3
# one results directory meshed by the two packages: the recon metrics of
# the port's mesh against the JAX mesh equal those of the JAX mesh against
# itself (the metric's own floor: samples to the nearest vertex of a
# 0.25 m grid), and the two meshes' metrics against the world agree,
# within 1 mm (Chamfer, accuracy, completeness) and 0.2 % (F-score)
MESH_CM = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other workers of a parallel test run, torch's intra-op
    thread pool would oversubscribe the cores.  One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.postprocessing, "
            "splatloam_tpu_torch.cli; "
            "from splatloam_tpu_torch.postprocessing import mesh_tsdf; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's SLAM results (5 frames, 60 iterations) and the world
    cloud it saw, as a reference PLY."""
    tmp = tmp_path_factory.mktemp("mesh")
    d = jconfig.to_dict(synthetic.make_config(
        tmp, mapping={"num_iterations": 60}, compute={"backend": "auto"}))
    cfg = pconfig.from_dict(pconfig.Configuration, d)
    reset_datalogger()
    rng = np.random.default_rng(0)
    poses = synthetic.straight_trajectory(5, step=0.4)
    pre, slam = Preprocessor(cfg, device="cpu"), SLAM(cfg, device="cpu")
    for i, pose in enumerate(poses):
        slam.process(pre(synthetic.sensor_cloud(rng, pose), 0.1 * i,
                         gt_pose=pose))
    rdir = slam.save_results()
    world = synthetic.scene_cloud_world(np.random.default_rng(1), n=20000)
    ref = tmp / "world.ply"
    write_ply(ref, {"x": world[:, 0], "y": world[:, 1], "z": world[:, 2]})
    return {"dir": rdir, "ref": ref, "n_ref": len(world), "tmp": tmp}


def _graph_args(rdir):
    return (post.ResultGraph.from_yaml(rdir / "graph.yaml"),
            pconfig.load_configuration(rdir / "cfg.yaml"),
            jpost.ResultGraph.from_yaml(rdir / "graph.yaml"),
            jconfig.load_configuration(rdir / "cfg.yaml"))


def test_mesh_needs_a_gpu_or_cpu_by_name(run):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["mesh", str(run["dir"]), "-o", str(run["tmp"] / "x.ply")])


@pytest.mark.parametrize("samples", [None, 500])
def test_render_graph_points_matches_jax(run, samples):
    """Every keyframe of the submap rendered, filtered by alpha and
    distortion, back-projected and merged: the same pixels pass the
    filter in both packages (no flipped pixel at this scale), so the
    seeded draws of ``kf_samples`` pick the same points."""
    graph, cfg, jgraph, jcfg = _graph_args(run["dir"])
    assert len(graph.frames) >= 2
    pts, nrm = post.render_graph_points(graph, cfg, run["dir"],
                                        kf_samples=samples, device="cpu")
    jpts, jnrm = jpost.render_graph_points(jgraph, jcfg, run["dir"],
                                           kf_samples=samples)
    flipped = abs(len(pts) - len(jpts))
    assert flipped == 0, f"{flipped} pixels pass one filter only"
    assert len(pts) >= (1000 if samples is None else 2 * samples)
    np.testing.assert_allclose(pts, jpts, atol=POINT_ATOL)
    np.testing.assert_allclose(nrm, jnrm, atol=NORMAL_ATOL)


@pytest.fixture(scope="module")
def meshes(run):
    """Each package's CLI `mesh` of the results, TSDF and grid Poisson."""
    out = {}
    for method, args in (("tsdf", ["--voxel-size", "0.25", "--trunc",
                                   "0.75"]),
                         ("poisson", ["--method", "poisson",
                                      "--poisson-width", "0.25"])):
        for who, main in (("port", cli.main), ("jax", jcli.main)):
            out[method, who] = run["tmp"] / f"{method}_{who}.ply"
            extra = ["--device", "cpu"] if who == "port" else []
            main(["mesh", str(run["dir"]), "-o", str(out[method, who]),
                  *args, *extra])
    return out


def _mesh_distance(a, b):
    return evaluate_recon(a, b, down_sample_res=0.05,
                          mesh_sample_point=20_000, gt_bbox_mask_on=False)


@pytest.mark.parametrize("method", ["tsdf", "poisson"])
def test_cli_mesh_matches_jax(run, meshes, method):
    out = {who: meshes[method, who] for who in ("port", "jax")}
    verts, faces = load_mesh(out["port"])
    jverts, jfaces = load_mesh(out["jax"])
    assert len(faces) > 100 and np.isfinite(verts).all()
    assert abs(len(faces) - len(jfaces)) <= 0.02 * len(jfaces)
    # the port's mesh against the JAX mesh's vertices, beside the JAX
    # mesh against its own, and both against the world they map
    d = _mesh_distance(out["jax"], out["port"])
    d0 = _mesh_distance(out["jax"], out["jax"])
    assert abs(d["Chamfer_L1 (cm)"] - d0["Chamfer_L1 (cm)"]) < MESH_CM, \
        (d, d0)
    assert d["F-score (%)"] > d0["F-score (%)"] - 0.2, (d, d0)
    kw = dict(down_sample_res=0.1, mesh_sample_point=50_000)
    got = evaluate_recon(run["ref"], out["port"], **kw)
    want = jrecon.evaluate_recon(run["ref"], out["jax"], **kw)
    for key in ("Chamfer_L1 (cm)", "MAE_accuracy (cm)",
                "MAE_completeness (cm)"):
        assert abs(got[key] - want[key]) < MESH_CM, (key, got, want)
    assert abs(got["F-score (%)"] - want["F-score (%)"]) < 0.2


def test_cli_eval_recon_and_crop_match_jax(run, meshes, capsys):
    """eval_recon: the same TLDR line and CSV (the port writes it with the
    csv module, JAX with pandas); crop_recon: the same cropped cloud."""
    mesh = meshes["tsdf", "port"]
    lines, csvs = [], []
    for who, main in (("port", cli.main), ("jax", jcli.main)):
        out = run["tmp"] / f"recon_{who}.csv"
        capsys.readouterr()
        main(["eval_recon", str(run["ref"]), str(mesh), "--output", str(out),
              "--mesh-sample-point", "50000", "--down-sample-res", "0.1"])
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("TLDR:")])
        with open(out, newline="") as f:
            csvs.append(list(csv.reader(f)))
    assert lines[0] == lines[1] and len(lines[0]) == 1
    assert csvs[0][0] == csvs[1][0]
    np.testing.assert_allclose(np.asarray(csvs[0][1][1:], float),
                               np.asarray(csvs[1][1][1:], float), rtol=1e-12)
    assert csvs[0][1][0] == csvs[1][1][0] == mesh.stem

    crops = []
    for who, main in (("port", cli.main), ("jax", jcli.main)):
        out = run["tmp"] / f"crop_{who}.ply"
        main(["crop_recon", str(run["ref"]), str(mesh), "--output", str(out),
              "--mesh-sample-point", "20000", "--threshold-dist", "0.3"])
        crops.append(read_ply(out))
    assert 0 < len(crops[0]["x"]) < run["n_ref"]
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(crops[0][k], crops[1][k])
