"""The gradients of the final-T and median channels through the port's
kernel path, against the golden renderers, on the CPU.

The kernel path folds final T's cotangent into alpha's (alpha + final T
= 1 over the composited slots) and adds the median's at the slot the
forward chose for each pixel (the kernels' MED variant; here their plain
versions).  Both are held to the port's eager renderer and to JAX's
``rasterize_jnp`` (autodiff through the compositing) on every layout and
reduction: tiled under ranksum, rmw, fused and plan, flat, bucketed
(ranksum and fused per bucket) and ``render_batch`` over two views.
JAX's Pallas path drops both channels, so nothing here is held to it.
Tolerances: 2e-3 x max|g| for the surfel parameters, 3e-3 x max|g| for
the pose.  Last, the mapper's optimize loop with ``opt.depth_ratio`` 0.5
(the median in the depth loss) against the JAX mapper's on its jnp
backend.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloam_tpu import config as jconfig
from splatloam_tpu.model import surfels as JS
from splatloam_tpu.model.local_model import LocalModel as JLocalModel
from splatloam_tpu.ops.rasterizer.jnp_ref import rasterize_jnp
from splatloam_tpu.slam import mapper as jmapper
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch.convert import surfels_to_numpy
from splatloam_tpu_torch.model import surfels as S
from splatloam_tpu_torch.model.local_model import LocalModel
from splatloam_tpu_torch.ops.rasterizer import binning, common, kernels
from splatloam_tpu_torch.ops.rasterizer.api import RenderParams, rasterize
from splatloam_tpu_torch.ops.rasterizer.cuda_raster import (
    prepare_tiles, rasterize_cuda_batched)
from splatloam_tpu_torch.ops.rasterizer.eager_ref import rasterize_eager
from splatloam_tpu_torch.slam import mapper
from test_torch_mapper import (BASE, CAP, EMA_RTOL, _assert_pools, _lrs,
                               frames)  # noqa: F401
from test_torch_raster import GEO, H, W, _posed, _scene

NAMES = ["xyz", "scales", "quat", "opacity", "T_cw"]
RELS = [2e-3] * 4 + [3e-3]
LOSSES = {"final_T": lambda c: c["final_T"].sum(),
          "median": lambda c: c["median"].sum()}
LAYOUTS = {
    "ranksum": dict(scatter="ranksum"),
    "rmw": dict(scatter="rmw"),
    "fused": dict(scatter="fused"),
    "plan": dict(scatter="plan"),
    "flat": dict(layout="flat"),
    "bucketed_ranksum": dict(layout="bucketed", scatter="ranksum"),
    "bucketed_fused": dict(layout="bucketed", scatter="fused"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Beside the other workers of a parallel test run, torch's intra-op
    thread pool would oversubscribe the cores.  One thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.ops.rasterizer.cuda_raster, "
            "splatloam_tpu_torch.slam.mapper; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


def _views():
    """The scene of ROADMAP queue 3 (seed 0, 120 surfels, posed) and a
    second, unposed view of it."""
    posed = _posed(_scene(np.random.default_rng(0), n=120))
    return posed, posed[:4] + _scene(np.random.default_rng(0), n=120)[4:]


def _grads_torch(render_fn, scene, loss):
    leaves = [torch.tensor(a, requires_grad=True) for a in scene[:5]]
    out = render_fn(*leaves, torch.tensor(scene[5]))
    gs = torch.autograd.grad(loss(out), leaves, allow_unused=True)
    return [np.zeros(l.shape, np.float32) if g is None else g.numpy()
            for g, l in zip(gs, leaves)]


@pytest.fixture(scope="module")
def refs():
    """Per channel: the eager renderer's and JAX rasterize_jnp's
    gradients on each view."""
    out = {}
    for name, loss in LOSSES.items():
        for v, scene in enumerate(_views()):
            out[name, v, "eager"] = _grads_torch(
                lambda *a: rasterize_eager(*a, H, W, GEO["chunk"]), scene,
                loss)
            jK = jnp.asarray(scene[5])
            g = jax.grad(lambda *a: loss(rasterize_jnp(*a, jK, H, W)),
                         argnums=(0, 1, 2, 3, 4))(
                *map(jnp.asarray, scene[:5]))
            out[name, v, "jax"] = [np.asarray(x) for x in g]
    return out


def _assert_grads(got, ref, what):
    for name, gp, gr, rel in zip(NAMES, got, ref, RELS):
        np.testing.assert_allclose(gp, gr,
                                   atol=rel * (np.abs(gr).max() + 1e-6),
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("channel", list(LOSSES))
def test_channel_gradients(refs, channel, layout):
    """Before the repairs the kernel path gave 0 for both channels."""
    scene = _views()[0]
    params = RenderParams(backend="cuda", **GEO, **LAYOUTS[layout])
    got = _grads_torch(lambda *a: rasterize(*a, params), scene,
                       LOSSES[channel])
    assert max(np.abs(g).max() for g in got) > 0
    for oracle in ("eager", "jax"):
        _assert_grads(got, refs[channel, 0, oracle], f"{oracle} {layout}")


@pytest.mark.parametrize("scatter", ["ranksum", "rmw", "flat"])
@pytest.mark.parametrize("channel", list(LOSSES))
def test_channel_gradients_render_batch(refs, channel, scatter):
    """Two views through one launch of each kernel: each view's pose
    gradient and the surfel gradients summed over the views."""
    views = _views()
    layout = dict(layout="flat") if scatter == "flat" else \
        dict(scatter=scatter)
    params = RenderParams(backend="cuda", **GEO, **layout)
    leaves = [torch.tensor(a, requires_grad=True) for a in views[0][:4]]
    T_cw = torch.tensor(np.stack([v[4] for v in views]), requires_grad=True)
    K = torch.tensor(np.stack([v[5] for v in views]))
    out = rasterize_cuda_batched(*leaves, T_cw, K, params)
    got = torch.autograd.grad(LOSSES[channel](out), leaves + [T_cw])
    for oracle in ("eager", "jax"):
        ref = [refs[channel, 0, oracle][i] + refs[channel, 1, oracle][i]
               for i in range(4)]
        _assert_grads([g.numpy() for g in got[:4]], ref,
                      f"{oracle} batched {scatter}")
        for v in range(2):
            gr = refs[channel, v, oracle][4]
            np.testing.assert_allclose(
                got[4][v].numpy(), gr, atol=3e-3 * (np.abs(gr).max() + 1e-6),
                err_msg=f"{oracle} batched {scatter} T_cw view {v}")


@pytest.mark.parametrize("flat", [False, True])
def test_median_slot_names_the_median(flat):
    """The forward's med_slot is the slot whose depth is each pixel's
    median (-1 exactly where the median is 0); the backward without it
    leaves the median undifferentiated, as before the repair."""
    scene = [torch.tensor(a) for a in _views()[0]]
    params = RenderParams(backend="cuda", **GEO,
                          **(dict(layout="flat") if flat else {}))
    tiles = prepare_tiles(*scene, params)
    F = binning.pack_features(common.pack_surfels(*scene))
    kw = dict(chunk=GEO["chunk"], width=W, with_median=True, with_dist=True)
    if flat:
        out, tb, slot = kernels.raster_fwd_flat(
            F, tiles.flat_ids, tiles.starts[None], tiles.rays_t, tiles.pix_t,
            return_slot=True, **kw)
        lists, *_ = kernels._flat_as_tiles(tiles.flat_ids, tiles.starts[None],
                                           GEO["chunk"])
    else:
        out, tb, slot = kernels.raster_fwd(
            F, tiles.lists, tiles.counts, tiles.rays_t, tiles.pix_t,
            return_slot=True, **kw)
        lists = tiles.lists
    med = out[..., 5]
    has = slot >= 0
    assert bool(has.any())
    assert bool((has == (med != 0)).all())
    ids = torch.gather(lists, 1, slot.clamp(min=0).long())       # [T, P]
    geo = kernels._splat_geometry(F[ids.reshape(-1).long()][:, None],
                                  tiles.rays_t.reshape(-1, 1, 3),
                                  tiles.pix_t.reshape(-1, 1, 2), W)
    m = geo["m"].reshape(med.shape)
    np.testing.assert_allclose(m[has].numpy(), med[has].numpy(), rtol=1e-6)

    # the median's cotangent alone: no gradient without med_slot
    g = torch.zeros_like(out)
    g[..., 5] = 1.0
    bwd = kernels.raster_bwd_flat if flat else kernels.raster_bwd
    args = ((F, tiles.flat_ids, tiles.starts[None]) if flat else
            (F, tiles.lists, tiles.counts))
    bkw = dict(chunk=GEO["chunk"], width=W, with_dist=True)
    rest = (tiles.rays_t, tiles.pix_t, tb, out, g)
    assert float(bwd(*args, *rest, **bkw).abs().max()) == 0.0
    assert float(bwd(*args, *rest, med_slot=slot, **bkw).abs().max()) > 0


def test_mapper_update_with_median_depth(frames):  # noqa: F811
    """opt.depth_ratio 0.5 (the depth loss on the blend of expected and
    median depth): the mapper's optimize loop of 8 iterations against the
    JAX mapper's on its jnp backend (loss EMA and pool tolerances as
    tests/test_torch_mapper.py's).  The loop rebins every iteration: the
    jnp reference bins nothing, and a pixel's median jumps to another
    surfel where one enters or leaves a tile list frozen between rebins.
    Measured on this pool, the largest parameter error over its
    tolerance: 0.0005 at rebin 1; at rebin 4, 1.05 (one quaternion
    component), where the port's eager backend, which bins nothing
    either, gives 0.0007."""
    def build(mod, backend):
        d = {k: dict(v) for k, v in BASE.items()}
        d["compute"].update(backend=backend, rebin_every=1)
        d["opt"] = {"depth_ratio": 0.5}
        return mod.from_dict(mod.Configuration, d)

    jcfg, pcfg = build(jconfig, "jnp"), build(pconfig, "cuda")
    fh, fw = BASE["preprocessing"]["image_height"], \
        BASE["preprocessing"]["image_width"]
    jprogs = jmapper.MapperPrograms(jcfg, fh, fw, CAP)
    pprogs = mapper.MapperPrograms(pcfg, fh, fw, CAP)
    # the start pool: the port's densification of the first keyframe,
    # handed to both packages
    gumbel = np.random.default_rng(5).gumbel(size=fh * fw)
    psurf, padam, _, _ = mapper.densify_core(
        S.empty_surfels(CAP, "cpu"), S.empty_adam(CAP, "cpu"),
        frames[0][1].camera_in_model(),
        torch.tensor(gumbel, dtype=torch.float32), None, mc=pcfg.mapping,
        max_new=pprogs.max_new, height=fh, width=fw)
    params, active, state = surfels_to_numpy(psurf, padam)
    jsurf = JS.Surfels(JS.SurfelParams(**{k: jnp.asarray(v) for k, v in
                                          params.items()}),
                       jnp.asarray(active))
    jadam = JS.AdamState(*(JS.SurfelParams(**{k: jnp.asarray(v) for k, v in
                                              state[m].items()})
                           for m in ("mu", "nu")),
                         jnp.asarray(state["step"], jnp.int32))
    assert pprogs.params.with_median
    jlm, plm = JLocalModel(jcfg), LocalModel(pcfg, device="cpu")
    for jfr, pfr in frames:
        jlm.insert_keyframe(jfr)
        plm.insert_keyframe(pfr)
    probs = mapper.sample_geometric_probs(2, 0.4, 8)
    log_probs = np.full((8,), -np.inf, np.float32)
    log_probs[:2] = np.log(probs[:2])
    jkf = jmapper.KeyframeBatch(**jlm.kf_stack,
                                log_probs=jnp.asarray(log_probs))
    pkf = mapper.KeyframeBatch(**plm.kf_stack, probs=probs)

    key = jax.random.PRNGKey(0)
    idx = [int(jax.random.categorical(k, jnp.asarray(log_probs)))
           for k in jax.random.split(key, pprogs.n_blocks())]
    js, ja, jema, jn = jprogs._optimize(jsurf, jadam, jkf, key)
    ps, pa, pema, pn = pprogs.optimize(psurf, padam, pkf, torch.tensor(idx))
    assert pn == int(jn) and pa.step == int(ja.step)
    np.testing.assert_allclose(float(pema), float(jema), rtol=EMA_RTOL)
    _assert_pools(ps, js, atol=1e-4, n_iters=pn, lrs=_lrs(pcfg))
