"""The port's multi-device mapping (splatloam_tpu_torch/parallel/) over
torch.distributed, against the JAX package.

Pure functions (ring_combine, the packed state rows, tile_image, the
depth partition, the snake deal, the send-byte conventions) run here
against their JAX counterparts on the same arrays.  Everything that
needs a mesh runs in ONE spawn of 4 gloo ranks on the CPU for the whole
file: the module fixture starts this file as a script 4 times (the
entry point at the bottom imports torch and the port only, no JAX),
every rank builds the (2,2), (4,1) and (1,4) meshes over the same 4
ranks, runs the checks of ``_rank_main`` and writes its results; the
tests below hold them to the JAX package's SINGLE-device counterparts,
the contract JAX holds its own sharded programs to, at the tolerances of
tests/test_parallel.py.  Random draws (Gumbel noise, keyframe indices)
come from jax.random in the parent and are handed to the ranks.
"""
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

H, W = 16, 256
CAP = 512
WORLD = 4
RANK_TIMEOUT_S = 300
GRAD_KERNEL_TOL = 2e-3          # x max|g|, the kernel path's gradient bound
# the optimize configuration of every partition: 2 keyframes, 8 Adam
# iterations in 2 rebin blocks.  The ring runs with opt_scaling_max under
# the densify init scales (RING_SCALING_MAX), as JAX's ring test does, so
# the band-local scale penalty is active and a mis-scaled channel gradient
# changes the loss; there the update is chaotic at the Adam step's scale
# (a 1e-7 relative change of the start xyz moves xyz by up to 2.7e-3 after
# 8 iterations on one device), hence JAX's looser paired ring tolerances.
RING_SCALING_MAX = 0.05
UPDATE = {
    "preprocessing": {"image_height": H, "image_width": W,
                      "depth_min": 0.5, "depth_max": 30.0,
                      "enable_normal_estimation": False,
                      "enable_ground_segmentation": False},
    "mapping": {"num_iterations": 7, "densify_percentage": 0.1,
                "densify_threshold_opacity": 0.5,
                "densify_threshold_egeom": 0.2,
                "prob_view_last_keyframe": 0.4, "pruning_min_opacity": 0.05,
                "opt_scaling_max": 1.0,
                "lmodel_threshold_ngaussians": 60000},
    "tracking": {"method": "gt", "keyframe_threshold_nframes": 2,
                 "keyframe_threshold_distance": -1,
                 "keyframe_threshold_fitness": -1},
    "compute": {"initial_capacity": CAP, "keyframe_capacity": 8,
                "chunk": 256, "rebin_every": 4, "tile_list_capacity": 512},
    "logging": {"enable": False},
}
KF_CAP = 8


def _update_dict(backend, scaling_max=1.0, **compute):
    d = {k: dict(v) for k, v in UPDATE.items()}
    d["compute"].update(backend=backend, **compute)
    d["mapping"]["opt_scaling_max"] = scaling_max
    return d


# ---------------------------------------------------------------------------
# inputs, built by the port's functions from numpy seeds (ranks and parent)
# ---------------------------------------------------------------------------

def _scene():
    """tests/test_parallel.py:_setup's scene: 200 surfels on a cylinder of
    radius 6 in a pool of CAP slots, depth 6 everywhere."""
    from splatloam_tpu_torch.geometry import se3, spherical
    from splatloam_tpu_torch.model import surfels as S
    rng = np.random.default_rng(0)
    n = 200
    theta = rng.uniform(-np.pi, np.pi, n)
    xyz = np.stack([6 * np.cos(theta), 6 * np.sin(theta),
                    rng.uniform(-1, 1, n)], -1).astype(np.float32)
    normals = -xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    xyz_t = torch.from_numpy(xyz)
    surf = S.empty_surfels(CAP, "cpu")
    adam = S.empty_adam(CAP, "cpu")
    newp = S.SurfelParams(
        xyz=xyz_t, log_scale=torch.full((n, 2), -1.0),
        quat=se3.quat_from_normal(torch.from_numpy(normals)),
        logit_opacity=torch.full((n,), 2.0))
    surf, adam, _ = S.insert_surfels(surf, adam, newp, n)
    K, _, _ = spherical.spherical_intrinsics(xyz_t, H, W)
    return (surf, adam, K, torch.eye(4), torch.full((H, W), 6.0),
            torch.ones((H, W), dtype=torch.bool))


def _cameras():
    """tests/test_parallel.py:_camera's keyframe (a wavy cylinder) and a
    second one 0.3 m along x."""
    from splatloam_tpu_torch.geometry import spherical
    from splatloam_tpu_torch.model.camera import Camera
    from splatloam_tpu_torch.ops.rasterizer import common
    rng = np.random.default_rng(1)
    theta = rng.uniform(-np.pi, np.pi, 3000)
    xyz = np.stack([8 * np.cos(theta), 8 * np.sin(theta),
                    rng.uniform(-1, 1, 3000)], -1).astype(np.float32)
    K, _, _ = spherical.spherical_intrinsics(torch.from_numpy(xyz), H, W)
    u = np.arange(W)[None, :] * np.ones((H, 1))
    v = np.arange(H)[:, None] * np.ones((1, W))
    depth = (6.0 + 0.8 * np.sin(u * 0.12) + 0.5 * np.cos(v * 0.4)
             ).astype(np.float32)
    rays, _ = common.pixel_grid(K, H, W)
    cam = Camera(K=K, T_cw=torch.eye(4), depth=torch.from_numpy(depth),
                 normal=-rays, valid=torch.ones((H, W), dtype=torch.bool))
    T2 = torch.tensor([[1, 0, 0, -0.3], [0, 1, 0, 0.1], [0, 0, 1, 0],
                       [0, 0, 0, 1]], dtype=torch.float32)
    return cam, cam._replace(T_cw=T2)


def _kf_batch(cams, probs):
    from splatloam_tpu_torch.slam.mapper import KeyframeBatch

    def pad(xs):
        x = torch.stack(xs)
        return torch.cat([x, x.new_zeros((KF_CAP - len(xs),) + x.shape[1:])])
    return KeyframeBatch(K=pad([c.K for c in cams]),
                         T_cw=pad([c.T_cw for c in cams]),
                         depth=pad([c.depth for c in cams]),
                         valid=pad([c.valid for c in cams]), probs=probs)


def _thinned(surf, adam):
    """A pool with the surfels of one half-space (x > 0) cleared, so a
    densify on it finds pixels to fill."""
    keep = surf.params.xyz[:, 0] < 0.0
    return surf._replace(active=surf.active & keep), adam


def _ring_loss(c):
    return (torch.sum(c["depth_sum"]) * 0.1 + torch.sum(c["alpha"])
            + 0.5 * torch.sum(c["normal_sum"]))


def _np_pool(surf, adam=None):
    out = {f"p_{k}": v.detach().numpy()
           for k, v in zip(surf.params._fields, surf.params)}
    out["active"] = surf.active.numpy()
    if adam is not None:
        out.update({f"mu_{k}": v.numpy()
                    for k, v in zip(adam.mu._fields, adam.mu)})
        out["step"] = np.asarray(adam.step)
    return out


# ---------------------------------------------------------------------------
# the rank entry point: torch and the port only
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from splatloam_tpu_torch import config as pconfig
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.ops.rasterizer.api import RenderParams
    from splatloam_tpu_torch.parallel import (initialize_distributed,
                                              make_mesh, stats)
    from splatloam_tpu_torch.parallel import collectives as C
    from splatloam_tpu_torch.parallel import ring, sharded
    from splatloam_tpu_torch.slam import mapper

    initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                           device="cpu", timeout_s=RANK_TIMEOUT_S)
    draws = dict(np.load(Path(outdir) / "draws.npz"))
    res = {}
    meshes = {shape: make_mesh(*shape, device="cpu")
              for shape in ((2, 2), (4, 1), (1, 4))}
    res["backend"] = meshes[(2, 2)].backend
    res["staged"] = meshes[(2, 2)].group("data").staged
    try:
        make_mesh(2, 1, device="cpu")
    except ValueError as e:
        res["mesh_error"] = str(e)

    # --- sharded_train_step on each mesh (eager = the jnp golden path) ---
    surf, adam, K, T_cw, depth, valid = _scene()
    for shape, mesh in meshes.items():
        step = sharded.sharded_train_step(
            mesh, RenderParams(height=H, width=W, backend="eager"),
            S.AdamHyper(), lambda_alpha=0.1, lambda_normal=0.1,
            scaling_max=0.5, scaling_max_penalty=0.2)
        s_sh, a_sh = sharded.shard_model_state(mesh, surf, adam)
        s2, a2, loss = step(s_sh, a_sh, K, T_cw, depth, valid)
        s2, a2 = sharded.gather_model_state(mesh, s2, a2)
        res[f"step{shape}"] = dict(loss=float(loss), **_np_pool(s2, a2))

    # --- ring_render at (1, 4): forward + gradients, eager and cuda ---
    mesh = meshes[(1, 4)]
    perm = ring.depth_partition_shards(surf, T_cw, 4)
    inv = torch.argsort(perm)
    for backend in ("eager", "cuda"):
        rp = RenderParams(height=H, width=W, backend=backend, tile_h=8,
                          tile_w=32, tile_list_capacity=512)
        fn = ring.ring_render(mesh, rp, with_dist=backend == "eager")
        p_sh = sharded._slice_model(S.SurfelParams(
            *(a[perm] for a in surf.params)), mesh)
        p_sh = S.SurfelParams(*(a.requires_grad_(True) for a in p_sh))
        act_sh = sharded._slice_model(surf.active[perm], mesh)
        out = fn(p_sh, act_sh, T_cw, K)
        # every model rank holds the composite: its loss counts once
        grads = torch.autograd.grad(_ring_loss(out) / mesh.model, p_sh)
        full = [C.all_gather_raw(g.contiguous(), mesh.group("model"))[inv]
                for g in grads]
        res[f"ring_render_{backend}"] = dict(
            {k: v.detach().numpy() for k, v in out.items()},
            **{f"g_{k}": g.numpy() for k, g in
               zip(S.SurfelParams._fields, full)})

    # --- the mapper's update: densify -> optimize -> prune ---
    cam, cam2 = _cameras()
    probs = mapper.sample_geometric_probs(2, 0.4, KF_CAP)
    kf = _kf_batch([cam, cam2], probs)
    kf_idx = torch.from_numpy(draws["kf_idx"])
    gumbel = torch.from_numpy(draws["gumbel"])

    def programs(mesh, backend, **kw):
        cfg = pconfig.from_dict(pconfig.Configuration,
                                _update_dict(backend, **kw))
        return cfg, mapper.MapperPrograms(cfg, H, W, CAP)

    mesh = meshes[(2, 2)]
    pools = {}           # the densified full pool, by opt_scaling_max
    for smax in (1.0, RING_SCALING_MAX):
        cfg, progs = programs(mesh, "eager", scaling_max=smax)
        dens = sharded.sharded_densify(mesh, progs.params, cfg.mapping,
                                       progs.max_new)
        s0, a0 = sharded.shard_model_state(
            mesh, S.empty_surfels(CAP, "cpu"), S.empty_adam(CAP, "cpu"))
        s_d, a_d, n_d, m_d = dens[True](s0, a0, cam, gumbel)
        pools[smax] = sharded.gather_model_state(mesh, s_d, a_d)
        if smax == 1.0:
            res["densify"] = dict(n=int(n_d), mask=m_d.numpy(),
                                  **_np_pool(*pools[smax]))
    s_d, a_d = sharded.shard_model_state(mesh, *pools[1.0])

    def run_opt(name, mesh, builder, backend, scaling_max=1.0, **kw):
        cfg, progs = programs(mesh, backend, scaling_max=scaling_max, **kw)
        opt = builder(mesh, progs.params, progs.hyper, cfg.mapping,
                      cfg.compute, cfg.opt.depth_ratio)
        s_sh, a_sh = sharded.shard_model_state(mesh, *pools[scaling_max])
        s2, a2, ema, it = opt(s_sh, a_sh, kf, kf_idx)
        s3, n_pruned = sharded.sharded_prune(mesh, cfg.mapping)(s2)
        full_s, full_a = sharded.gather_model_state(mesh, s3, a2)
        res[name] = dict(ema=float(ema), iters=int(it),
                         n_pruned=int(n_pruned), **_np_pool(full_s, full_a))

    run_opt("rows", mesh, sharded.sharded_optimize, "eager")
    run_opt("rows_cuda", mesh, sharded.sharded_optimize, "cuda")
    for scatter in ("ranksum", "rmw"):
        run_opt(f"tiles_{scatter}", mesh, sharded.sharded_optimize_tiles,
                "cuda", scatter=scatter)
    run_opt("tiles_compact", mesh, sharded.sharded_optimize_tiles, "cuda",
            compact_param_comms=True)
    for shape in ((2, 2), (1, 4)):
        run_opt(f"ring{shape}", meshes[shape],
                sharded.sharded_optimize_ring, "cuda",
                scaling_max=RING_SCALING_MAX)

    # densify on a map (its row-block render), kernel path, keyframe 2
    cfg, progs = programs(mesh, "cuda")
    dens = sharded.sharded_densify(mesh, progs.params, cfg.mapping,
                                   progs.max_new)
    s_m, a_m = sharded.shard_model_state(mesh, *_thinned(*pools[1.0]))
    s_m, a_m, n_m, m_m = dens[False](s_m, a_m, cam2, gumbel)
    res["densify_map"] = dict(n=int(n_m), mask=m_m.numpy(),
                              **_np_pool(*sharded.gather_model_state(
                                  mesh, s_m, a_m)))

    # --- one "tiles" iteration's counted send bytes at (2, 2) ---
    cfg, progs = programs(mesh, "cuda")
    opt = sharded.sharded_optimize_tiles(mesh, progs.params, progs.hyper,
                                         cfg.mapping, cfg.compute)
    tiles = opt.make_tiles(s_d, kf, kf_idx[0])
    stats.reset()
    opt.one_iter(s_d, a_d, kf, kf_idx[0], tiles)
    res["bytes_tiles"] = stats.counted()

    # --- the Mapper's draws come from rank 0 ---
    cfg = pconfig.from_dict(pconfig.Configuration, dict(
        _update_dict("cuda"), parallel={"data": 2, "model": 2}))
    pm = mapper.Mapper(cfg, device="cpu", seed=rank)
    draw = torch.cat([pm._gumbel(64),
                      pm._draw_keyframes(probs, 8, 1).to(torch.float32)])
    res["draws"] = C.all_gather_raw(draw[None], mesh.group("world")).numpy()

    # --- three frames of SLAM.process at (2, 2), tracked by gsaligner ---
    res["slam"] = _rank_slam(mesh, outdir)

    dist.barrier()
    torch.save(res, Path(outdir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def _rank_slam(mesh, outdir):
    import synthetic
    from splatloam_tpu_torch import config as pconfig
    from splatloam_tpu_torch.ops.rasterizer.api import RenderParams, render
    from splatloam_tpu_torch.preprocessing import Preprocessor
    from splatloam_tpu_torch.slam import SLAM

    d = _update_dict("cuda", initial_capacity=2048, rebin_every=8)
    d["preprocessing"].update(image_height=16, image_width=128)
    d["mapping"].update(num_iterations=16, densify_percentage=0.6,
                        opt_scaling_max=1.0)
    d["tracking"] = {"method": "gsaligner", "keyframe_threshold_nframes": 1,
                     "keyframe_threshold_distance": -1,
                     "keyframe_threshold_fitness": -1}
    d["parallel"] = {"data": 2, "model": 2}
    d["output"] = {"folder": str(Path(outdir) / f"results{mesh.rank}"),
                   "writer": "tum"}
    cfg = pconfig.from_dict(pconfig.Configuration, d)
    rng = np.random.default_rng(0)
    poses = synthetic.straight_trajectory(3, step=0.4)
    pre = Preprocessor(cfg, device="cpu")
    slam = SLAM(cfg, device="cpu")
    for i, pose in enumerate(poses):
        slam.process(pre(synthetic.sensor_cloud(rng, pose), 0.1 * i,
                         gt_pose=pose))
    model = slam.local_models[-1]
    cam = model.keyframes[0].camera_in_model()
    s = model.surfels
    out = render(s.params.xyz, s.scaling, s.rotation, s.opacity, cam.T_cw,
                 cam.K, RenderParams(cam.height, cam.width, backend="eager"))
    valid = cam.valid.numpy()
    l1 = np.abs(out["surf_depth"].numpy() - cam.depth.numpy())
    return dict(poses=np.stack(slam.world_T_odom),
                n_keyframes=len(model.keyframes),
                median_l1=float(np.median(l1[valid])),
                results=str(slam.save_results()),
                **_np_pool(s, model.adam))


# ---------------------------------------------------------------------------
# the parent: one spawn of the ranks for the whole file
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths run thousands of small ops; beside the other
    workers of a parallel test run, torch's intra-op thread pool would
    oversubscribe the cores and wait in its barriers.  One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_draws():
    """The Gumbel noise of densify (key 7) and the optimize's per-block
    keyframe indices (key 3), as the JAX mapper draws them."""
    import jax
    import jax.numpy as jnp
    from splatloam_tpu_torch.slam import mapper
    probs = mapper.sample_geometric_probs(2, 0.4, KF_CAP)
    log_probs = np.full((KF_CAP,), -np.inf, np.float32)
    log_probs[:2] = np.log(probs[:2])
    gumbel = np.asarray(jax.random.gumbel(jax.random.PRNGKey(7), (H * W,)))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    kf_idx = np.array([int(jax.random.categorical(k, jnp.asarray(log_probs)))
                       for k in keys])
    return dict(gumbel=gumbel, kf_idx=kf_idx, log_probs=log_probs)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4 gloo ranks once; every rank's results, by rank."""
    outdir = tmp_path_factory.mktemp("ranks")
    draws = _jax_draws()
    np.savez(outdir / "draws.npz", **draws)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).parent), str(Path(__file__).parents[1])]
        + ([env["PYTHONPATH"]] if "PYTHONPATH" in env else []))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(port),
         str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, start_new_session=True) for r in range(WORLD)]
    logs = []
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        refs = _references()      # computed while the ranks run
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:          # kill every rank's group on any exit
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    res = [torch.load(outdir / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    res[0]["seconds"] = time.perf_counter() - t0
    return res, refs


def _references():
    """Everything the ranks are held to, on one device: JAX's train step,
    ring render and mapper update, and the port's single-device update."""
    import jax
    from test_parallel import _single_device_reference
    from splatloam_tpu.model import surfels as JS
    step = jax.jit(_single_device_reference, static_argnums=(6,))
    return {
        "train": step(*_jax_scene(), JS.AdamHyper()),
        "ring": _jax_ring_reference(),
        "update": {smax: _jax_update(smax)
                   for smax in (1.0, RING_SCALING_MAX)},
        "single": {name: _port_update(backend, **compute)
                   for name, (backend, compute) in UPDATES.items()},
    }


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.parallel, "
            "splatloam_tpu_torch.parallel.ring, "
            "splatloam_tpu_torch.parallel.stats; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


# ---------------------------------------------------------------------------
# pure functions against JAX on the same arrays
# ---------------------------------------------------------------------------

def _seg(rng, shape, with_dist):
    seg = dict(T=rng.uniform(0, 1, shape), alpha=rng.uniform(0, 1, shape),
               depth_sum=rng.uniform(0, 30, shape),
               normal_sum=rng.normal(size=shape + (3,)))
    if with_dist:
        seg["dist"] = rng.uniform(0, 5, shape)
    return {k: v.astype(np.float32) for k, v in seg.items()}


@pytest.mark.parametrize("with_dist", [False, True])
def test_ring_combine_matches_jax(with_dist):
    import jax.numpy as jnp
    from splatloam_tpu.parallel import ring as jring
    from splatloam_tpu_torch.parallel import ring
    rng = np.random.default_rng(0)
    f, b = _seg(rng, (4, 9), with_dist), _seg(rng, (4, 9), with_dist)
    out = ring.ring_combine({k: torch.from_numpy(v) for k, v in f.items()},
                            {k: torch.from_numpy(v) for k, v in b.items()})
    ref = jring.ring_combine({k: jnp.asarray(v) for k, v in f.items()},
                             {k: jnp.asarray(v) for k, v in b.items()})
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_state_rows_match_jax():
    import jax.numpy as jnp
    from splatloam_tpu.model import surfels as JS
    from splatloam_tpu.parallel import ring as jring
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.parallel import ring
    rng = np.random.default_rng(1)
    n = 37

    def params():
        return [rng.normal(size=s).astype(np.float32)
                for s in ((n, 3), (n, 2), (n, 4), (n,))]
    p, mu, nu = params(), params(), params()
    active = rng.uniform(size=n) > 0.3
    rows = ring._pack_state_rows(
        *(S.SurfelParams(*map(torch.from_numpy, x)) for x in (p,)),
        torch.from_numpy(active),
        *(S.SurfelParams(*map(torch.from_numpy, x)) for x in (mu, nu)))
    jrows = jring._pack_state_rows(
        JS.SurfelParams(*map(jnp.asarray, p)), jnp.asarray(active),
        JS.SurfelParams(*map(jnp.asarray, mu)),
        JS.SurfelParams(*map(jnp.asarray, nu)))
    assert rows.shape == (n, ring.STATE_WIDTH)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    back, jback = ring._unpack_state_rows(rows), \
        jring._unpack_state_rows(jrows)
    for a, b in zip((back[0], back[2], back[3]),
                    (jback[0], jback[2], jback[3])):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(back[1].numpy(), np.asarray(jback[1]))
    np.testing.assert_array_equal(back[1].numpy(), active)


@pytest.mark.parametrize("channels", [0, 3])
def test_tile_image_matches_jax(channels):
    import jax.numpy as jnp
    from splatloam_tpu.ops.rasterizer import binning as JB
    from splatloam_tpu_torch.ops.rasterizer import binning as BN
    rng = np.random.default_rng(2)
    shape = (H, W) + ((channels,) if channels else ())
    img = rng.normal(size=shape).astype(np.float32)
    t = BN.tile_image(torch.from_numpy(img), 8, 32)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(JB.tile_image(jnp.asarray(img), 8, 32)))
    if not channels:
        back = BN.untile_image(t, H, W, 8, 32)
        np.testing.assert_array_equal(back.numpy(), img)
        np.testing.assert_array_equal(back.numpy(), np.asarray(
            JB.untile_image(jnp.asarray(t.numpy()), H, W, 8, 32)))


def test_depth_partition_matches_jax():
    import jax.numpy as jnp
    from splatloam_tpu.model import surfels as JS
    from splatloam_tpu.parallel import ring as jring
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.parallel import ring
    surf, *_ = _scene()
    T = torch.tensor([[1, 0, 0, -0.3], [0, 1, 0, 0.1], [0, 0, 1, 0.2],
                      [0, 0, 0, 1]], dtype=torch.float32)
    perm = ring.depth_partition_shards(surf, T, 4)
    jsurf = JS.Surfels(params=JS.SurfelParams(
        *(jnp.asarray(a.numpy()) for a in surf.params)),
        active=jnp.asarray(surf.active.numpy()))
    jperm = jring.depth_partition_shards(jsurf, jnp.asarray(T.numpy()), 4)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert isinstance(surf, S.Surfels)


def test_snake_deal_matches_jax():
    """The tile deal of sharded_optimize_tiles/_ring against JAX's on the
    same counts (ties included), at n_data 2 and 4."""
    import jax.numpy as jnp
    from splatloam_tpu_torch.parallel import sharded
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 40, 64).astype(np.int32)
    counts[::7] = 5                                   # ties
    for n in (2, 4):
        order = jnp.argsort(-jnp.asarray(counts))
        mat = order.reshape(-1, n)
        odd = (jnp.arange(mat.shape[0]) % 2 == 1)[:, None]
        mat = np.asarray(jnp.where(odd, mat[:, ::-1], mat))
        for d in range(n):
            mesh = type("M", (), {"data": n, "data_index": d})()
            mine, inv = sharded._snake_deal(torch.from_numpy(counts), mesh)
            np.testing.assert_array_equal(mine.numpy(), mat[:, d])
            scatter_perm = mat.T.reshape(-1)
            np.testing.assert_array_equal(
                np.arange(64)[scatter_perm][inv.numpy()], np.arange(64))


def test_send_byte_conventions_match_jax():
    from splatloam_tpu.parallel import stats as jstats
    from splatloam_tpu_torch.parallel import stats
    ops, jops = [], []
    for kind in ("all-gather", "all-reduce", "reduce-scatter",
                 "collective-permute"):
        for nbytes in (4, 1000, 123456):
            for g in (1, 2, 4, 8):
                s = stats._send_bytes(kind, nbytes, g)
                assert s == jstats._send_bytes(kind, nbytes, g), (kind, g)
                ops.append(stats.CollectiveOp(kind, nbytes, g, s))
                jops.append(jstats.CollectiveOp(kind, nbytes, g, s, ""))
    assert stats.send_bytes_by_bucket(ops) == \
        jstats.send_bytes_by_bucket(jops)


def test_mapper_needs_the_ranks():
    """parallel.data*model > 1 without that many ranks is a clear error."""
    from splatloam_tpu_torch import config as pconfig
    from splatloam_tpu_torch.slam import mapper
    cfg = pconfig.from_dict(pconfig.Configuration, dict(
        _update_dict("cuda"), parallel={"data": 2, "model": 2}))
    with pytest.raises(RuntimeError, match="needs 4 torch.distributed"):
        mapper.Mapper(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the ranks' results against the JAX package's single-device programs
# ---------------------------------------------------------------------------

def _jnp(x):
    import jax.numpy as jnp
    return jnp.asarray(x.numpy() if torch.is_tensor(x) else x)


def _jax_scene():
    from splatloam_tpu.model import surfels as JS
    surf, adam, K, T_cw, depth, valid = _scene()
    jsurf = JS.Surfels(params=JS.SurfelParams(*map(_jnp, surf.params)),
                       active=_jnp(surf.active))
    jadam = JS.AdamState(mu=JS.SurfelParams(*map(_jnp, adam.mu)),
                         nu=JS.SurfelParams(*map(_jnp, adam.nu)),
                         step=_jnp(np.int32(0)))
    return jsurf, jadam, _jnp(K), _jnp(T_cw), _jnp(depth), _jnp(valid)


def test_ranks_agree_and_mesh_checks(ranks):
    res, _ = ranks
    r0 = res[0]
    assert r0["backend"] == "gloo" and not r0["staged"]
    assert "!= world size 4" in r0["mesh_error"]
    draws = r0["draws"]
    for r in range(WORLD):                 # every rank drew rank 0's
        np.testing.assert_array_equal(draws[r], draws[0])
    for r in range(1, WORLD):
        np.testing.assert_array_equal(res[r]["draws"], draws)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_sharded_train_step_matches_single_device(ranks, shape):
    res, refs = ranks
    ref_s, ref_a, ref_loss = refs["train"]
    for r in range(WORLD):
        out = res[r][f"step{shape}"]
        np.testing.assert_allclose(out["loss"], float(ref_loss), rtol=2e-5)
        np.testing.assert_allclose(out["p_xyz"],
                                   np.asarray(ref_s.params.xyz), atol=2e-5)
        np.testing.assert_allclose(out["mu_xyz"], np.asarray(ref_a.mu.xyz),
                                   atol=1e-5)
        assert int(out["step"]) == 1


def _jax_ring_reference():
    import jax
    import jax.numpy as jnp
    from splatloam_tpu.ops.rasterizer.jnp_ref import rasterize_jnp
    jsurf, _, K, T_cw, _, _ = _jax_scene()
    ref = rasterize_jnp(jsurf.params.xyz, jsurf.scaling, jsurf.rotation,
                        jsurf.opacity, T_cw, K, H, W)

    def loss_ref(p):
        c = rasterize_jnp(p.xyz, jnp.exp(p.log_scale), p.quat,
                          jax.nn.sigmoid(p.logit_opacity) * jsurf.active,
                          T_cw, K, H, W)
        return (jnp.sum(c["depth_sum"]) * 0.1 + jnp.sum(c["alpha"])
                + 0.5 * jnp.sum(c["normal_sum"]))
    return ref, jax.grad(loss_ref)(jsurf.params), np.asarray(jsurf.active)


@pytest.mark.parametrize("backend", ["eager", "cuda"])
def test_ring_render_matches_single_device(ranks, backend):
    """ring_render at model 4 against the single jnp render; on the
    kernel path the early-exit gap is held to its bound
    (ring.early_exit_bound) on the pixels where a final T is at most
    T_EPS, which are counted, and to the forward tolerances elsewhere."""
    from splatloam_tpu_torch.ops.rasterizer.common import T_EPS
    from splatloam_tpu_torch.parallel import ring
    res, refs = ranks
    ref, g_ref, act = refs["ring"]
    surf, *_ = _scene()
    bound = ring.early_exit_bound(
        float(torch.linalg.norm(surf.params.xyz, dim=-1).max()) + 1.0)
    out = res[0][f"ring_render_{backend}"]
    ref_T = np.asarray(ref["final_T"])
    exit_px = np.minimum(out["T"], ref_T) <= T_EPS
    print(f"[ring] {backend}: {int(exit_px.sum())} pixels with a final T "
          f"<= T_EPS, bound {bound}")
    tols = {"alpha": 2e-5, "T": 2e-5, "depth_sum": 2e-4, "normal_sum": 2e-4}
    if backend == "eager":
        tols["dist"] = 3e-4
    for k, tol in tols.items():
        r = np.asarray(ref["final_T" if k == "T" else k])
        diff = np.abs(out[k] - r)
        keep = ~exit_px if backend == "cuda" else np.ones_like(exit_px)
        if diff.ndim == 3:
            keep = keep[..., None]
        assert float(np.where(keep, diff, 0).max()) <= tol, k
        if backend == "cuda":
            assert float(np.where(keep, 0, diff).max()) <= \
                bound[k] + tol, k
    for r in range(1, WORLD):                 # every rank holds the fold
        np.testing.assert_array_equal(res[r][f"ring_render_{backend}"]["T"],
                                      out["T"])
    # gradients through the fold, unpermuted, on the active surfels
    for name, gr in zip(("xyz", "log_scale", "quat", "logit_opacity"),
                        g_ref):
        gp = out[f"g_{name}"][act]
        gr = np.asarray(gr)[act]
        scale = float(np.abs(gr).max())
        tol = (3e-5 * max(scale, 1.0) if backend == "eager"
               else GRAD_KERNEL_TOL * scale)
        err = float(np.abs(gp - gr).max())
        print(f"[ring] {backend} grad {name}: max|diff| {err:.3e} = "
              f"{err / scale:.2e} x max|g|")
        assert err <= tol, name


def _jax_update(scaling_max):
    """JAX's single-device MapperPrograms on its jnp backend: densify
    (initialize, key 7), optimize over 2 keyframes (key 3), prune."""
    import jax
    import jax.numpy as jnp
    from splatloam_tpu import config as jconfig
    from splatloam_tpu.model import surfels as JS
    from splatloam_tpu.model.camera import Camera as JCamera
    from splatloam_tpu.slam.mapper import KeyframeBatch, MapperPrograms
    cam, cam2 = _cameras()
    d = _update_dict("jnp", scaling_max)
    cfg = jconfig.from_dict(jconfig.Configuration, d)
    progs = MapperPrograms(cfg, H, W, CAP)
    jcam = JCamera(*(_jnp(x) for x in cam))
    s, a, n, m = progs._densify(JS.empty_surfels(CAP), JS.empty_adam(CAP),
                                jcam, jax.random.PRNGKey(7),
                                initialize=True)
    draws = _jax_draws()

    def pad(xs):
        x = jnp.stack([_jnp(v) for v in xs])
        return jnp.concatenate([x, jnp.zeros((KF_CAP - len(xs),)
                                             + x.shape[1:], x.dtype)])
    kf = KeyframeBatch(K=pad([cam.K, cam2.K]), T_cw=pad([cam.T_cw,
                                                         cam2.T_cw]),
                       depth=pad([cam.depth, cam2.depth]),
                       valid=pad([cam.valid, cam2.valid]),
                       log_probs=jnp.asarray(draws["log_probs"]))
    s2, a2, ema, it = progs._optimize(s, a, kf, jax.random.PRNGKey(3))
    s3, n_pruned = progs._prune(s2)
    return dict(densify=(s, int(n), np.asarray(m)),
                optimize=(s3, a2, float(ema), int(it), int(n_pruned)))


def test_sharded_densify_matches_single_device(ranks):
    res, refs = ranks
    s_ref, n_ref, m_ref = refs["update"][1.0]["densify"]
    for r in range(WORLD):
        out = res[r]["densify"]
        assert out["n"] == n_ref > 50
        np.testing.assert_array_equal(out["mask"], m_ref)
        np.testing.assert_allclose(out["p_xyz"], np.asarray(s_ref.params.xyz),
                                   atol=1e-6)
        np.testing.assert_array_equal(out["active"],
                                      np.asarray(s_ref.active))


def _port_update(backend, **compute):
    """The port's single-device MapperPrograms on the same draws."""
    from splatloam_tpu_torch import config as pconfig
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.slam import mapper
    draws = _jax_draws()
    cam, cam2 = _cameras()
    kf = _kf_batch([cam, cam2], mapper.sample_geometric_probs(2, 0.4,
                                                              KF_CAP))
    cfg = pconfig.from_dict(pconfig.Configuration,
                            _update_dict(backend, **compute))
    progs = mapper.MapperPrograms(cfg, H, W, CAP)
    s, a, _, _ = progs.densify(S.empty_surfels(CAP, "cpu"),
                               S.empty_adam(CAP, "cpu"), cam,
                               torch.from_numpy(draws["gumbel"].copy()),
                               initialize=True)
    s2, a2, ema, it = progs.optimize(s, a, kf,
                                     torch.from_numpy(draws["kf_idx"]))
    s3, n_pruned = progs.prune(s2)
    lrs = {"p_xyz": cfg.opt.position_lr,
           "p_logit_opacity": cfg.opt.opacity_lr}
    return dict(ema=float(ema), iters=int(it), n_pruned=int(n_pruned),
                **_np_pool(s3, a2)), lrs


UPDATES = {"rows": ("eager", {}), "rows_cuda": ("cuda", {}),
           "tiles_ranksum": ("cuda", {"scatter": "ranksum"}),
           "tiles_rmw": ("cuda", {"scatter": "rmw"})}


@pytest.mark.parametrize("name", list(UPDATES))
def test_sharded_update_matches_single_device(ranks, name):
    """optimize + prune through the rows partition (eager and the
    kernels' plain versions) and the tiles partition (the plain versions,
    ranksum and rmw) at (2,2),
    given the same keyframe indices.

    Against the port's single-device MapperPrograms on the same backend
    and reduction: tests/test_parallel.py's tolerances, the contract JAX
    holds its own sharded programs to.  Against JAX's single-device jnp
    mapper: the port's mapper tolerance of tests/test_torch_mapper.py
    (params 1e-4 + lr per Adam step, EMA 1e-3 relative), because here the
    single-device port and JAX differ by float ordering alone and Adam
    with eps 1e-15 turns that into up to lr a step: the port's own
    single-device update sits 2.3e-4 (xyz) and 1.7e-3 (logit opacity)
    from JAX's on one surfel each."""
    res, refs = ranks
    single, lrs = refs["single"][name]
    s_ref, a_ref, ema_ref, it_ref, np_ref = refs["update"][1.0]["optimize"]
    ref = {"p_xyz": np.asarray(s_ref.params.xyz),
           "p_logit_opacity": np.asarray(s_ref.params.logit_opacity)}
    for r in range(WORLD):
        out = res[r][name]
        assert out["iters"] == single["iters"] == it_ref == 8
        assert out["n_pruned"] == single["n_pruned"] == np_ref
        assert int(out["step"]) == single["step"] == int(a_ref.step)
        np.testing.assert_array_equal(out["active"], single["active"])
        np.testing.assert_array_equal(out["active"],
                                      np.asarray(s_ref.active))
        np.testing.assert_allclose(out["ema"], single["ema"], rtol=1e-4)
        for key, tol in (("p_xyz", 5e-5), ("p_logit_opacity", 5e-4),
                         ("mu_xyz", 5e-5)):
            np.testing.assert_allclose(out[key], single[key], atol=tol,
                                       err_msg=key)
        np.testing.assert_allclose(out["ema"], ema_ref, rtol=1e-3)
        for key, lr in lrs.items():
            np.testing.assert_allclose(out[key], ref[key],
                                       atol=1e-4 + lr * out["iters"],
                                       err_msg=key)


def test_sharded_densify_on_a_map_matches_single_device(ranks):
    """densify on a map (not initialize): the row-block render on the
    kernel path (each rank's block of a whole-image binning), gathered
    over "data", against the port's single-device densify on the same
    pool and Gumbel noise."""
    from splatloam_tpu_torch import config as pconfig
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.slam import mapper
    res, _ = ranks
    draws = _jax_draws()
    cam, cam2 = _cameras()
    cfg = pconfig.from_dict(pconfig.Configuration, _update_dict("cuda"))
    progs = mapper.MapperPrograms(cfg, H, W, CAP)
    gumbel = torch.from_numpy(draws["gumbel"].copy())
    s, a, _, _ = progs.densify(S.empty_surfels(CAP, "cpu"),
                               S.empty_adam(CAP, "cpu"), cam, gumbel,
                               initialize=True)
    s2, a2, n2, m2 = progs.densify(*_thinned(s, a), cam2, gumbel,
                                   initialize=False)
    for r in range(WORLD):
        out = res[r]["densify_map"]
        assert out["n"] == int(n2) > 0
        np.testing.assert_array_equal(out["mask"], m2.numpy())
        np.testing.assert_array_equal(out["active"], s2.active.numpy())
        np.testing.assert_allclose(out["p_xyz"], s2.params.xyz.numpy(),
                                   atol=1e-6)


def test_compact_param_comms_tracks_fp32(ranks):
    """compact_param_comms (float16 gather of the non-position leaves)
    against the float32 run, at JAX's gates: the same iteration count,
    EMA within 2% relative, median |dxyz| < 5e-3."""
    res, _ = ranks
    a, b = res[0]["tiles_ranksum"], res[0]["tiles_compact"]
    assert a["iters"] == b["iters"]
    assert b["ema"] == pytest.approx(a["ema"], rel=0.02)
    assert np.median(np.abs(a["p_xyz"] - b["p_xyz"])) < 5e-3


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_ring_update_matches_single_device(ranks, shape):
    """sharded_optimize_ring against the single-device mapper: the same
    iteration count and EMA, the final pool paired slot by slot by
    position (the reshard permutes slots; tests/test_parallel.py's
    pairing and tolerances)."""
    res, refs = ranks
    s_ref, a_ref, ema_ref, it_ref, _ = \
        refs["update"][RING_SCALING_MAX]["optimize"]
    out = res[0][f"ring{shape}"]
    assert out["iters"] == it_ref
    np.testing.assert_allclose(out["ema"], ema_ref, rtol=1e-4)
    act_r = np.asarray(s_ref.active)
    act_s = out["active"]
    xr = np.asarray(s_ref.params.xyz)[act_r]
    xs = out["p_xyz"][act_s]
    assert xr.shape == xs.shape
    dist = np.linalg.norm(xs[:, None, :] - xr[None, :, :], axis=-1)
    j = dist.argmin(1)
    assert len(set(j.tolist())) == len(j), "slot pairing not a bijection"
    assert float(dist.min(1).max()) < 0.05
    for key, ref, tol in [
            ("p_logit_opacity", s_ref.params.logit_opacity, 0.05),
            ("p_log_scale", s_ref.params.log_scale, 0.05),
            ("mu_xyz", a_ref.mu.xyz, 5e-3)]:
        np.testing.assert_allclose(out[key][act_s], np.asarray(ref)[act_r][j],
                                   atol=tol, err_msg=key)
    assert int(out["step"]) == int(a_ref.step)
    for r in range(1, WORLD):
        for key in ("p_xyz", "active", "mu_xyz"):
            np.testing.assert_array_equal(res[r][f"ring{shape}"][key],
                                          out[key])


def test_tiles_send_bytes_match_formula(ranks):
    """One "tiles" iteration's counted send bytes per device at (2,2)
    against the formula of the JAX package's dryrun (copied from
    __graft_entry__.py), bucketed by (kind, group size): both axes have 2
    ranks, so the model axis's parameter gather and the data axis's
    depth gather share the all-gather_g2 bucket."""
    res, _ = ranks
    n_data = n_model = 2
    cap, img_px, f32 = CAP, H * W, 4
    row_b = 10 * f32 + 1               # 10 f32 params + 1-byte active
    depth_b = (n_data - 1) * img_px * f32 // n_data
    formula = {
        "all_gather_params_model": (n_model - 1) * (cap // n_model) * row_b,
        "psum_grads_data": 2 * (n_data - 1) * (cap * 10 * f32 + f32)
        // n_data,
        "all_gather_render_depth_data": depth_b,
        "reduce_scatter_depth_cotangent_data": depth_b,
    }
    expect = {
        "all-gather_g2": formula["all_gather_params_model"]
        + formula["all_gather_render_depth_data"],
        "all-reduce_g2": formula["psum_grads_data"],
        "reduce-scatter_g2": formula["reduce_scatter_depth_cotangent_data"],
    }
    for r in range(WORLD):
        counted = res[r]["bytes_tiles"]
        assert counted["send"] == expect, (counted, expect)
        assert counted["staged"] == 0          # CPU tensors under gloo


def test_slam_on_four_ranks(ranks):
    """Three frames of SLAM.process at (2,2) (the tiles partition, the
    kernels' plain versions, gsaligner tracking): every rank holds the
    same poses and pool, the map fits the first keyframe, and only rank
    0 wrote results."""
    res, _ = ranks
    s0 = res[0]["slam"]
    assert s0["n_keyframes"] >= 2
    assert s0["median_l1"] < 0.5
    assert Path(s0["results"]).is_dir()
    for r in range(1, WORLD):
        sr = res[r]["slam"]
        assert sr["results"] == "None"
        np.testing.assert_array_equal(sr["poses"], s0["poses"])
        for key in ("p_xyz", "p_quat", "active", "mu_xyz"):
            np.testing.assert_array_equal(sr[key], s0[key], err_msg=key)
    print(f"[ranks] 4 gloo ranks took {res[0]['seconds']:.1f} s")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    _rank_main(*(int(a) for a in sys.argv[1:4]), sys.argv[4])
