"""The slice: the PyTorch port's mapper against the JAX package's, at
16x128 with a few hundred surfels, 8 Adam iterations per update at rebin 4.

The JAX mapper renders with its golden jnp backend; the port with its
tiled path ("cuda", each kernel's plain version on the CPU) and the
ranksum reduction, so every comparison also holds the port's kernels
against the reference renderer; the optimize loop also runs under the
other three reductions (rmw, fused, plan).  Both packages get the same
random draws:
the Gumbel noise and the keyframe indices are drawn with jax.random and
handed to the port.
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

from splatloam_tpu import config as jconfig
from splatloam_tpu.model import surfels as JS
from splatloam_tpu.model.camera import make_camera as j_make_camera
from splatloam_tpu.model.frame import Frame as JFrame
from splatloam_tpu.model.local_model import LocalModel as JLocalModel
from splatloam_tpu.preprocessing import _preprocess_device
from splatloam_tpu.slam import mapper as jmapper
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch.convert import surfels_from_numpy, surfels_to_numpy
from splatloam_tpu_torch.model import surfels as S
from splatloam_tpu_torch.model.camera import make_camera
from splatloam_tpu_torch.model.frame import Frame
from splatloam_tpu_torch.model.local_model import LocalModel
from splatloam_tpu_torch.slam import mapper

H, W = 16, 128
# pool capacity: large enough that the port's tile lists (capacity/8 slots,
# at most 1024) hold every surfel, as the jnp reference has no list cap
CAP = 8192
BASE = {
    "preprocessing": {"image_height": H, "image_width": W,
                      "depth_min": 0.5, "depth_max": 30.0},
    "mapping": {"num_iterations": 7, "densify_percentage": 0.15,
                "densify_threshold_opacity": 0.5,
                "prob_view_last_keyframe": 0.4, "pruning_min_opacity": 0.05,
                "opt_scaling_max": 1.0, "lmodel_threshold_ngaussians": 60000},
    "compute": {"initial_capacity": CAP, "keyframe_capacity": 8,
                "rebin_every": 4},
    "logging": {"enable": False},
}


def _cfgs(scatter="ranksum", **mapping):
    """(JAX config on the jnp backend, port config on the cuda backend
    with the gradient reduction ``scatter``)."""
    def build(mod, backend, compute):
        d = {k: dict(v) for k, v in BASE.items()}
        d["compute"].update(backend=backend, **compute)
        d["mapping"].update(mapping)
        return mod.from_dict(mod.Configuration, d)
    return (build(jconfig, "jnp", {}),
            build(pconfig, "cuda", {"scatter": scatter}))


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.slam.mapper, "
            "splatloam_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def test_entry_points_need_a_gpu_or_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    _, pcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalModel(pcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mapper.Mapper(pcfg)


@pytest.fixture(scope="module")
def frames():
    """Two keyframes 0.5 m apart, preprocessed by the JAX package; the
    port's frames carry the same images."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.5 * i
        pts = synthetic.sensor_cloud(rng, pose, n=4000)
        K, depth, nimg, valid = _preprocess_device(
            jnp.asarray(pts), jnp.ones(len(pts), bool), H, W, 0.5, 30.0)
        arrs = [np.asarray(a) for a in (K, depth, nimg, valid)]
        out.append((JFrame(j_make_camera(*arrs), i, model_T_frame=pose),
                    Frame(make_camera(*arrs, device="cpu"), i,
                          model_T_frame=pose)))
    return out


def _pool_to_numpy(surf, adam=None):
    params = {k: np.asarray(getattr(surf.params, k))
              for k in JS.SurfelParams._fields}
    state = None
    if adam is not None:
        state = {"mu": {k: np.asarray(getattr(adam.mu, k))
                        for k in JS.SurfelParams._fields},
                 "nu": {k: np.asarray(getattr(adam.nu, k))
                        for k in JS.SurfelParams._fields},
                 "step": int(adam.step)}
    return params, np.asarray(surf.active), state


def _port_pool(surf, adam):
    return surfels_from_numpy(*_pool_to_numpy(surf, adam), device="cpu")


def _assert_pools(port, ref, atol, n_iters=0, lrs=None):
    """Active masks equal; active params within ``atol`` per field."""
    pp, pa, _ = surfels_to_numpy(port)
    rp, ra, _ = _pool_to_numpy(ref)
    np.testing.assert_array_equal(pa, ra)
    for k in JS.SurfelParams._fields:
        tol = atol if lrs is None else atol + lrs[k] * n_iters
        np.testing.assert_allclose(pp[k][ra], rp[k][ra], atol=tol,
                                   err_msg=k)


def _densified(jcfg, frame, key):
    """A JAX pool densified once from ``frame`` (initialization)."""
    progs = jmapper.MapperPrograms(jcfg, H, W, CAP)
    surf, adam = JS.empty_surfels(CAP), JS.empty_adam(CAP)
    cam = frame.camera_in_model()
    return jmapper.densify_core(surf, adam, cam, key, None,
                                mc=jcfg.mapping, max_new=progs.max_new,
                                height=H, width=W)[:2]


@pytest.mark.parametrize("initialize", [True, False])
def test_densify_core_same_gumbel(frames, initialize):
    jcfg, pcfg = _cfgs()
    jfr, pfr = frames[1]
    jprogs = jmapper.MapperPrograms(jcfg, H, W, CAP)
    pprogs = mapper.MapperPrograms(pcfg, H, W, CAP)
    if initialize:
        jsurf, jadam = JS.empty_surfels(CAP), JS.empty_adam(CAP)
        pkg = ppkg = None
    else:
        jsurf, jadam = _densified(jcfg, frames[0][0], jax.random.PRNGKey(5))
        cam = jfr.camera_in_model()
        pkg = jmapper.render(jsurf.params.xyz, jsurf.scaling, jsurf.rotation,
                             jsurf.opacity, cam.T_cw, cam.K, jprogs.params)
        ppkg = {k: torch.tensor(np.asarray(pkg[k]))
                for k in ("rend_alpha", "surf_depth")}
    key = jax.random.PRNGKey(7)
    gumbel = torch.tensor(np.asarray(jax.random.gumbel(key, (H * W,))))
    js, ja, jn, jmask = jmapper.densify_core(
        jsurf, jadam, jfr.camera_in_model(), key, pkg, mc=jcfg.mapping,
        max_new=jprogs.max_new, height=H, width=W)
    psurf, padam = _port_pool(jsurf, jadam)
    ps, pa, pn, pmask = mapper.densify_core(
        psurf, padam, pfr.camera_in_model(), gumbel, ppkg, mc=pcfg.mapping,
        max_new=pprogs.max_new, height=H, width=W)
    assert int(pn) == int(jn) > 0
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    _assert_pools(ps, js, atol=1e-5)


def test_loss_and_adam_step(frames):
    jcfg, pcfg = _cfgs()
    jsurf, jadam = _densified(jcfg, frames[0][0], jax.random.PRNGKey(5))
    jprogs = jmapper.MapperPrograms(jcfg, H, W, CAP)
    pprogs = mapper.MapperPrograms(pcfg, H, W, CAP)
    jlm, plm = JLocalModel(jcfg), LocalModel(pcfg, device="cpu")
    for jfr, pfr in frames:
        jlm.insert_keyframe(jfr)
        plm.insert_keyframe(pfr)
    jkf = jmapper.KeyframeBatch(**jlm.kf_stack,
                                log_probs=jnp.zeros((8,), jnp.float32))
    pkf = mapper.KeyframeBatch(**plm.kf_stack, probs=np.ones(8))

    jloss, jgrads = jax.value_and_grad(jprogs._loss)(
        jsurf.params, jsurf.active, jkf, 1)
    psurf, padam = _port_pool(jsurf, jadam)
    params = S.SurfelParams(*(p.clone().requires_grad_(True)
                              for p in psurf.params))
    ploss = pprogs._loss(params, psurf.active, pkf, 1)
    pgrads = torch.autograd.grad(ploss, params)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=1e-4)
    for name, gp, gr in zip(S.SurfelParams._fields, pgrads, jgrads):
        gr = np.asarray(gr)
        np.testing.assert_allclose(gp.numpy(), gr,
                                   atol=2e-3 * np.abs(gr).max() + 1e-8,
                                   err_msg=name)

    # the masked Adam step on identical gradients
    js, ja = JS.adam_step(jsurf, jadam, jgrads, jprogs.hyper)
    ps, pa = S.adam_step(psurf, padam, S.SurfelParams(
        *(torch.tensor(np.asarray(g)) for g in jgrads)), pprogs.hyper)
    _assert_pools(ps, js, atol=1e-6)
    assert pa.step == int(ja.step) == 1
    for k in S.SurfelParams._fields:
        np.testing.assert_allclose(getattr(pa.nu, k).numpy(),
                                   np.asarray(getattr(ja.nu, k)),
                                   rtol=1e-5, atol=1e-12)


def _lrs(cfg):
    oc = cfg.opt
    return {"xyz": oc.position_lr, "log_scale": oc.scaling_lr,
            "quat": oc.rotation_lr, "logit_opacity": oc.opacity_lr}


# Many Adam steps compound small gradient differences, and with eps 1e-15
# a step is close to sign(g) * lr for tiny gradients, so a near-zero
# gradient of either sign can move a parameter by up to ~lr per step.  The
# pool parameters are held to 1e-4 plus lr per Adam step run; the loss EMA
# to 1e-3 relative.
EMA_RTOL = 1e-3


@pytest.fixture(scope="module")
def block_loop_ref(frames):
    """The JAX optimize loop over both keyframes, with its start pool and
    per-block keyframe indices; the same reference for every reduction."""
    jcfg, pcfg = _cfgs()
    jsurf, jadam = _densified(jcfg, frames[0][0], jax.random.PRNGKey(5))
    jprogs = jmapper.MapperPrograms(jcfg, H, W, CAP)
    jlm = JLocalModel(jcfg)
    for jfr, _ in frames:
        jlm.insert_keyframe(jfr)
    probs = mapper.sample_geometric_probs(2, 0.4, 8)
    log_probs = np.full((8,), -np.inf, np.float32)
    log_probs[:2] = np.log(probs[:2])
    jkf = jmapper.KeyframeBatch(**jlm.kf_stack,
                                log_probs=jnp.asarray(log_probs))
    n_blocks = mapper.MapperPrograms(pcfg, H, W, CAP).n_blocks()
    for seed in range(100):             # a key that draws both keyframes
        key = jax.random.PRNGKey(seed)
        idx = [int(jax.random.categorical(k, jnp.asarray(log_probs)))
               for k in jax.random.split(key, n_blocks)]
        if len(set(idx)) == 2:
            break
    return (jsurf, jadam, probs, idx,
            jprogs._optimize(jsurf, jadam, jkf, key))


@pytest.mark.parametrize("scatter", ["ranksum", "rmw", "fused", "plan"])
def test_run_block_loop_same_keyframes(frames, block_loop_ref, scatter):
    """The optimize loop under each of the port's gradient reductions
    against the same JAX reference."""
    _, pcfg = _cfgs(scatter)
    jsurf, jadam, probs, idx, (js, ja, jema, jn) = block_loop_ref
    pprogs = mapper.MapperPrograms(pcfg, H, W, CAP)
    assert pprogs.params.scatter == scatter
    plm = LocalModel(pcfg, device="cpu")
    for _, pfr in frames:
        plm.insert_keyframe(pfr)
    pkf = mapper.KeyframeBatch(**plm.kf_stack, probs=probs)
    psurf, padam = _port_pool(jsurf, jadam)
    ps, pa, pema, pn = pprogs.optimize(psurf, padam, pkf, torch.tensor(idx))
    assert pn == int(jn) == 8
    assert pa.step == int(ja.step) == 8
    np.testing.assert_allclose(float(pema), float(jema), rtol=EMA_RTOL)
    _assert_pools(ps, js, atol=1e-4, n_iters=pn, lrs=_lrs(pcfg))


def test_prune_core(frames):
    jcfg, pcfg = _cfgs(pruning_min_size=0.05)
    jsurf, _ = _densified(jcfg, frames[0][0], jax.random.PRNGKey(5))
    rng = np.random.default_rng(3)
    n = jsurf.capacity
    jsurf = jsurf._replace(params=jsurf.params._replace(
        logit_opacity=jnp.asarray(rng.normal(0, 3, n).astype(np.float32)),
        log_scale=jnp.asarray(rng.normal(-2.5, 1, (n, 2))
                              .astype(np.float32))))
    js, jn = jmapper.prune_core(jsurf, mc=jcfg.mapping)
    psurf, _ = _port_pool(jsurf, None)
    ps, pn = mapper.prune_core(psurf, mc=pcfg.mapping)
    assert int(pn) == int(jn) > 0
    np.testing.assert_array_equal(ps.active.numpy(), np.asarray(js.active))


def test_update_model_slice(frames):
    """Mapper.update_model: initialize on keyframe 0, then densify ->
    optimize -> prune on keyframe 1; the JAX state is carried into the
    port between the two updates (convert.py), and the draws of the JAX
    mapper's key sequence are handed to the port."""
    jcfg, pcfg = _cfgs()
    jm = jmapper.Mapper(jcfg)
    jlm = JLocalModel(jcfg)
    jm.register_model(jlm)
    pm = mapper.Mapper(pcfg, device="cpu")
    plm = LocalModel(pcfg, device="cpu")
    pm.register_model(plm)

    state = {"key": jax.random.PRNGKey(0)}     # jmapper.Mapper's sequence

    def next_key():
        state["key"], sub = jax.random.split(state["key"])
        return sub

    def gumbel(n):
        return torch.tensor(np.asarray(jax.random.gumbel(next_key(), (n,))))

    def draw(probs, n_blocks, newest):
        # the JAX mapper draws from its own replay weights, which favour
        # the oldest keyframe where the port's favour the newest
        n = int((probs > 0).sum())
        jprobs = jmapper.sample_geometric_probs(
            n, pcfg.mapping.prob_view_last_keyframe, len(probs))
        lp = np.full(probs.shape, -np.inf, np.float32)
        lp[:n] = np.log(np.maximum(jprobs[:n], 1e-30))
        keys = jax.random.split(next_key(), n_blocks)
        return torch.tensor([int(jax.random.categorical(k, jnp.asarray(lp)))
                             for k in keys])

    pm._gumbel = gumbel
    pm._draw_keyframes = draw
    lrs = _lrs(pcfg)
    for i, (jfr, pfr) in enumerate(frames):
        jlm.insert_keyframe(jfr)
        plm.insert_keyframe(pfr)
        if i == 1:
            # carry the JAX pool across, so the second update starts equal
            plm.surfels, plm.adam = surfels_from_numpy(
                *_pool_to_numpy(jlm.surfels, jlm.adam), device="cpu")
        jm.update_model(jfr, initialize_model=(i == 0))
        pm.update_model(pfr, initialize_model=(i == 0))
        assert plm.capacity == jlm.capacity
        assert plm.no_gaussians == jlm.no_gaussians > 0
        assert pm.last_iters == 8
        np.testing.assert_allclose(float(pm.last_ema), float(jm._last_ema),
                                   rtol=EMA_RTOL)
        _assert_pools(plm.surfels, jlm.surfels, atol=1e-4, n_iters=8,
                      lrs=lrs)
    pkg = pm.render_frame(frames[1][1])
    assert pkg["rend_alpha"].shape == (H, W)
    assert bool(torch.isfinite(pkg["surf_depth"]).all())
