"""The port's compiled programs (splatloam_tpu_torch/graphs.py, the
mapper's block graphs, the tracker's captured Gauss-Newton loop) on the
CPU, against the JAX package and against the uncaptured loops.

A CUDA graph cannot be captured here, so these tests hold what runs
inside one: the device-side Adam step against JAX's ``adam_step`` (40
steps, from step 0 and from a restored step: parameters and moments
within 1e-6 relative, the step equal); the optimize blocks on their
static buffers (``MapperPrograms.optimize_static``), uncaptured and
through the capture protocol with a stand-in graph that replays the body,
bitwise against ``run_block_loop`` and, on the same keyframe draws,
against JAX's jitted loop at 16x256 with 60 iterations (the e2e smoke's),
early stopping at a block boundary and ``views_per_iteration`` 3
included (the repo's pool tolerance: 1e-4 plus each field's learning rate
per Adam step run; the loss EMA to 1e-3 relative); the bodies issue no
operation that reads a device value on the host; the GN loop on its
static buffers against JAX's ``gauss_newton_align`` (T within 1e-4,
fitness within 1e-3, tests/test_torch_tracker.py's tolerances); the
launch accounting of a replay; that a failed capture raises; the debug
checks' uncaptured loop; and the step across both packages' checkpoints
and convert.py.  ``TestOnCard`` holds the captured paths against the
uncaptured ones on a GPU and skips elsewhere.
"""
import contextlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import synthetic
import torch
from test_torch_mapper import EMA_RTOL, _assert_pools, _lrs
from test_torch_tracker import FIT_ATOL, T_ATOL, _fixture
from test_torch_tracker import H as TH
from test_torch_tracker import W as TW
from torch.utils._python_dispatch import TorchDispatchMode

from splatloam_tpu import checkpoint as jcheckpoint
from splatloam_tpu import config as jconfig
from splatloam_tpu import slam as jslam
from splatloam_tpu.model import surfels as JS
from splatloam_tpu.model.camera import make_camera as j_make_camera
from splatloam_tpu.model.frame import Frame as JFrame
from splatloam_tpu.model.local_model import LocalModel as JLocalModel
from splatloam_tpu.preprocessing import _preprocess_device
from splatloam_tpu.slam import mapper as jmapper
from splatloam_tpu.slam import tracker as jtracker
from splatloam_tpu_torch import checkpoint, debug, graphs
from splatloam_tpu_torch import config as pconfig
from splatloam_tpu_torch.convert import surfels_from_numpy, surfels_to_numpy
from splatloam_tpu_torch.model import surfels as S
from splatloam_tpu_torch.model.camera import make_camera
from splatloam_tpu_torch.model.frame import Frame
from splatloam_tpu_torch.model.local_model import LocalModel
from splatloam_tpu_torch.ops.rasterizer import cuda_raster, kernels
from splatloam_tpu_torch.preprocessing import Preprocessor
from splatloam_tpu_torch.slam import SLAM, mapper, tracker

H, W = 16, 256
# a 256-row pool holds the ~200 surfels densified from one sweep; its tile
# lists (the capacity / 8 rule's floor of one 256-slot chunk) hold them
# all, as the JAX jnp reference has no list cap
CAP = 256
ITERS = 60          # tests/test_e2e_slam.py's iterations per update
# the Adam step against JAX's: each field within 1e-6 of its largest
# magnitude (an element that an update brings near 0 keeps the rounding of
# the larger values it was computed from)
ADAM_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small CPU ops beside the other test workers: one
    intra-op thread (tests/test_torch_slam.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax():
    code = ("import sys, splatloam_tpu_torch.graphs, "
            "splatloam_tpu_torch.slam.mapper, "
            "splatloam_tpu_torch.slam.tracker; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'splatloam_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1])


# ---------------------------------------------------------------------------
# Adam's step on the device
# ---------------------------------------------------------------------------

def _random_pool(rng, cap=512, n_active=400):
    params = {"xyz": rng.normal(size=(cap, 3)),
              "log_scale": rng.normal(-3.0, 0.5, size=(cap, 2)),
              "quat": rng.normal(size=(cap, 4)),
              "logit_opacity": rng.normal(size=(cap,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    active = np.zeros(cap, bool)
    active[rng.choice(cap, n_active, replace=False)] = True
    return params, active


def _jax_state(params, active, step):
    surf = JS.Surfels(JS.SurfelParams(**{k: jnp.asarray(v)
                                         for k, v in params.items()}),
                      jnp.asarray(active))
    adam = JS.empty_adam(len(active))._replace(
        step=jnp.asarray(step, jnp.int32))
    return surf, adam


@pytest.mark.parametrize("start", [0, 1234])
def test_adam_step_on_device_matches_jax(start):
    """40 Adam steps on the same gradients; ``start`` 1234 is a step
    restored into the port through convert.py, as a JAX state or a
    checkpoint arrives."""
    rng = np.random.default_rng(3)
    params, active = _random_pool(rng)
    jsurf, jadam = _jax_state(params, active, start)
    psurf, padam = surfels_from_numpy(
        params, active, {"mu": {k: np.zeros_like(v) for k, v in
                                params.items()},
                         "nu": {k: np.zeros_like(v) for k, v in
                                params.items()},
                         "step": start}, device="cpu")
    assert padam.step.dtype == torch.int32 and padam.step.dim() == 0
    hyper = S.AdamHyper()
    jhyper = JS.AdamHyper()
    for _ in range(40):
        grads = {k: (rng.normal(size=v.shape)
                     * rng.choice([1e-6, 1e-2, 1.0])).astype(np.float32)
                 for k, v in params.items()}
        jsurf, jadam = JS.adam_step(
            jsurf, jadam, JS.SurfelParams(**{k: jnp.asarray(v) for k, v in
                                             grads.items()}), jhyper)
        psurf, padam = S.adam_step(
            psurf, padam, S.SurfelParams(**{k: torch.tensor(v) for k, v in
                                            grads.items()}), hyper)
    assert int(padam.step) == int(jadam.step) == start + 40
    assert padam.step.dtype == torch.int32
    for k in S.SurfelParams._fields:
        for p, j in ((psurf.params, jsurf.params), (padam.mu, jadam.mu),
                     (padam.nu, jadam.nu)):
            ref = np.asarray(getattr(j, k))
            np.testing.assert_allclose(getattr(p, k).numpy(), ref, rtol=0,
                                       atol=ADAM_RTOL * np.abs(ref).max(),
                                       err_msg=k)


def test_convert_carries_the_step_both_ways():
    rng = np.random.default_rng(4)
    params, active = _random_pool(rng, cap=64, n_active=20)
    jsurf, jadam = _jax_state(params, active, 77)
    mom = {k: np.asarray(getattr(jadam.mu, k)) for k in JS.SurfelParams._fields}
    state = {"mu": mom, "nu": mom, "step": int(jadam.step)}
    psurf, padam = surfels_from_numpy(params, active, state, device="cpu")
    assert padam.step.dtype == torch.int32 and int(padam.step) == 77
    back = surfels_to_numpy(psurf, padam)[2]
    assert isinstance(back["step"], int) and back["step"] == 77
    jback = JS.AdamState(mu=jadam.mu, nu=jadam.nu,
                         step=jnp.asarray(back["step"], jnp.int32))
    assert jback.step.dtype == jnp.int32 and int(jback.step) == 77


# ---------------------------------------------------------------------------
# scenes and configs at 16x256
# ---------------------------------------------------------------------------

def _cfgs(scatter="ranksum", iters=ITERS, **mapping):
    """(JAX config on the jnp backend, port config on the cuda backend's
    plain versions)."""
    def build(mod, backend, compute):
        d = {"preprocessing": {"image_height": H, "image_width": W,
                               "depth_min": 0.5, "depth_max": 30.0},
             "mapping": {"num_iterations": iters, "densify_percentage": 0.1,
                         "densify_threshold_opacity": 0.5,
                         "prob_view_last_keyframe": 0.4,
                         "pruning_min_opacity": 0.05,
                         "opt_scaling_max": 1.0, **mapping},
             "compute": {"initial_capacity": CAP, "keyframe_capacity": 8,
                         "rebin_every": 4, "backend": backend, **compute},
             "logging": {"enable": False}}
        return mod.from_dict(mod.Configuration, d)
    return (build(jconfig, "jnp", {}),
            build(pconfig, "cuda", {"scatter": scatter}))


@pytest.fixture(scope="module")
def scene():
    """Two keyframes 0.5 m apart (JAX-preprocessed, the same images in
    both packages), the JAX pool densified from the first, both keyframe
    stacks and the replay distribution."""
    rng = np.random.default_rng(0)
    jcfg, pcfg = _cfgs()
    jlm, plm = JLocalModel(jcfg), LocalModel(pcfg, device="cpu")
    jframes = []
    for i in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.5 * i
        pts = synthetic.sensor_cloud(rng, pose, n=8000)
        K, depth, nimg, valid = _preprocess_device(
            jnp.asarray(pts), jnp.ones(len(pts), bool), H, W, 0.5, 30.0)
        arrs = [np.asarray(a) for a in (K, depth, nimg, valid)]
        jfr = JFrame(j_make_camera(*arrs), i, model_T_frame=pose)
        jframes.append(jfr)
        jlm.insert_keyframe(jfr)
        plm.insert_keyframe(Frame(make_camera(*arrs, device="cpu"), i,
                                  model_T_frame=pose))
    progs = jmapper.MapperPrograms(jcfg, H, W, CAP)
    jsurf, jadam = jmapper.densify_core(
        JS.empty_surfels(CAP), JS.empty_adam(CAP),
        jframes[0].camera_in_model(), jax.random.PRNGKey(5), None,
        mc=jcfg.mapping, max_new=progs.max_new, height=H, width=W)[:2]
    assert 150 <= int(jsurf.active.sum()) <= 400
    probs = mapper.sample_geometric_probs(2, 0.4, 8)
    log_probs = np.full((8,), -np.inf, np.float32)
    log_probs[:2] = np.log(probs[:2])
    return dict(jsurf=jsurf, jadam=jadam, jstack=jlm.kf_stack,
                pkf=mapper.KeyframeBatch(**plm.kf_stack, probs=probs),
                log_probs=jnp.asarray(log_probs))


def _port_pool(jsurf, jadam):
    params = {k: np.asarray(getattr(jsurf.params, k))
              for k in JS.SurfelParams._fields}
    mom = [{k: np.asarray(getattr(m, k)) for k in JS.SurfelParams._fields}
           for m in (jadam.mu, jadam.nu)]
    return surfels_from_numpy(params, np.asarray(jsurf.active),
                              {"mu": mom[0], "nu": mom[1],
                               "step": int(jadam.step)}, device="cpu")


def _jax_draws(n_blocks: int, views: int, log_probs):
    """A key whose per-block draws visit both keyframes, and the draws,
    as the JAX loop makes them."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        idx = np.stack([np.asarray(jax.random.categorical(
            k, log_probs, shape=(views,) if views > 1 else None))
            for k in jax.random.split(key, n_blocks)])
        if len(set(idx.reshape(-1).tolist())) == 2:
            return key, idx
    raise AssertionError("no key draws both keyframes")


def _assert_same(a, b):
    """Two port optimize results, bitwise."""
    (sa, aa, ea, na), (sb, ab, eb, nb) = a, b
    assert na == nb
    assert int(aa.step) == int(ab.step)
    np.testing.assert_array_equal(ea.numpy(), eb.numpy())
    np.testing.assert_array_equal(sa.active.numpy(), sb.active.numpy())
    for k in S.SurfelParams._fields:
        for x, y in ((sa.params, sb.params), (aa.mu, ab.mu),
                     (aa.nu, ab.nu)):
            np.testing.assert_array_equal(getattr(x, k).numpy(),
                                          getattr(y, k).numpy(), err_msg=k)


class StandInGraph:
    """A replayable stand-in for a captured graph on the CPU: capturing
    records the body and runs nothing, as a real capture does; a replay
    runs the body."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def stand_in_capture(monkeypatch):
    """graphs.CapturedProgram on CPU tensors through the stand-in graph."""
    monkeypatch.setattr(graphs, "_check_device", lambda tensors: None)
    monkeypatch.setattr(graphs, "_side_stream", contextlib.nullcontext)
    monkeypatch.setattr(graphs, "_record",
                        lambda body: (StandInGraph(body), None, 0))


# ---------------------------------------------------------------------------
# the optimize blocks on static buffers
# ---------------------------------------------------------------------------

# The port's side of each comparison runs the kernels' plain versions,
# about 0.2 s an iteration here: the JAX comparisons run the static path
# once, and the static path meets run_block_loop bitwise on short updates.
JAX_CASES = {
    # (scatter, views, iterations, mapping overrides)
    "ranksum": ("ranksum", 1, ITERS, {}),
    # patience 8 at rebin 4: stop once two blocks in a row did not gain
    # half the best EMA (after 3 of the 16 blocks)
    "early_stop": ("ranksum", 1, ITERS,
                   {"early_stop_enable": True, "early_stop_patience": 8,
                    "early_stop_threshold": 0.5}),
    # B = 3 views an iteration cost 3 renders each: fewer iterations
    "views3": ("ranksum", 3, 7, {"views_per_iteration": 3}),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_static_blocks_match_jax(scene, case, stand_in_capture):
    """The blocks on static buffers (through the capture protocol where
    the update stops early, uncaptured otherwise) against JAX's jitted
    loop on the same keyframe draws."""
    scatter, views, iters, extra = JAX_CASES[case]
    jcfg, pcfg = _cfgs(scatter, iters, **extra)
    pprogs = mapper.MapperPrograms(pcfg, H, W, CAP)
    key, idx = _jax_draws(pprogs.n_blocks(), views, scene["log_probs"])
    jkf = jmapper.KeyframeBatch(**scene["jstack"],
                                log_probs=scene["log_probs"])
    js, ja, jema, jn = jmapper.MapperPrograms(jcfg, H, W, CAP)._optimize(
        scene["jsurf"], scene["jadam"], jkf, key)
    psurf, padam = _port_pool(scene["jsurf"], scene["jadam"])
    args = (psurf, padam, scene["pkf"], torch.tensor(idx))
    early = case == "early_stop"
    ps, pa, pema, pn = got = pprogs.optimize_static(*args, capture=early)
    if early:
        _assert_same(got, pprogs.optimize(*args))
        assert pn < pprogs.n_blocks() * pprogs.rebin
    else:
        assert pn == pprogs.n_blocks() * pprogs.rebin
    assert pn == int(jn)
    assert int(pa.step) == int(ja.step)
    np.testing.assert_allclose(float(pema), float(jema), rtol=EMA_RTOL)
    _assert_pools(ps, js, atol=1e-4, n_iters=pn, lrs=_lrs(pcfg))


@pytest.mark.parametrize("scatter,views,iters,rebin", [
    ("ranksum", 1, 3, 2), ("plan", 1, 3, 2), ("ranksum", 3, 1, 1)])
def test_static_blocks_match_run_block_loop(scene, stand_in_capture,
                                            scatter, views, iters, rebin):
    """Two-block updates on static buffers, uncaptured and through the
    capture protocol (block 0 uncaptured, the capture, where nothing runs,
    then replays; a second update at the signature replays from block 0),
    bitwise against run_block_loop.  Under "plan" the host rebins into
    the static tile buffers once per block, outside the graph."""
    _, pcfg = _cfgs(scatter, iters, views_per_iteration=views)
    pcfg.compute.rebin_every = rebin
    pprogs = mapper.MapperPrograms(pcfg, H, W, CAP)
    assert pprogs.n_blocks() == 2
    assert pprogs.rebin_outside == (scatter == "plan")
    _, idx = _jax_draws(pprogs.n_blocks(), views, scene["log_probs"])
    psurf, padam = _port_pool(scene["jsurf"], scene["jadam"])
    args = (psurf, padam, scene["pkf"], torch.tensor(idx))
    ref = pprogs.optimize(*args)
    _assert_same(pprogs.optimize_static(*args, capture=False), ref)
    assert pprogs.graph_stats() == {}
    for _ in range(2):
        _assert_same(pprogs.optimize_static(*args, capture=True), ref)
    (sig, stats), = pprogs.graph_stats().items()
    assert sig == (H, W, CAP, views, scatter, False, rebin, 8)
    assert (stats["captures"], stats["replays"]) == (1, 3)
    (static, _), = pprogs._graphs.values()
    if scatter == "plan":
        assert isinstance(static.tiles.plan, cuda_raster.ScatterPlan)
    else:
        assert static.tiles is None
    pprogs.release_graphs()
    assert pprogs.graph_stats() == {}


# ---------------------------------------------------------------------------
# the bodies read nothing back to the host
# ---------------------------------------------------------------------------

# operations that wait for the device and copy a value to the host, or
# copy host data to the device (not allowed while a graph is captured)
HOST_OPS = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten.lift_fresh", "aten._unique2", "aten.unique_dim",
            "aten.unique_consecutive", "aten.is_nonzero", "aten.equal",
            "aten.allclose"}
INDEX_OPS = {"aten.index", "aten.index_put", "aten.index_put_",
             "aten._index_put_impl_"}


class HostReads(TorchDispatchMode):
    """Records the operations that would read back to (or copy from) the
    host on CUDA: HOST_OPS, indexing by a boolean mask (a nonzero) and
    repeat_interleave without its output size.  ``paused`` skips the
    kernels' plain versions, which stand in for CUDA kernels here."""

    def __init__(self):
        super().__init__()
        self.found = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if not self.paused:
            indices = args[1] if name in INDEX_OPS else ()
            bool_index = any(torch.is_tensor(i) and i.dtype == torch.bool
                             for i in indices)
            rep = (name == "aten.repeat_interleave"
                   and kwargs.get("output_size") is None)
            if name in HOST_OPS or bool_index or rep:
                self.found.append(name)
        return func(*args, **kwargs)


@pytest.fixture
def host_reads(monkeypatch):
    mode = HostReads()

    def paused(fn):
        def run(*a, **kw):
            mode.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                mode.paused -= 1
        return run

    for name in dir(kernels):
        if name.endswith("_plain"):
            monkeypatch.setattr(kernels, name, paused(getattr(kernels, name)))
    return mode


@pytest.mark.parametrize("scatter,views", [("ranksum", 1), ("rmw", 1),
                                           ("fused", 1), ("plan", 1),
                                           ("ranksum", 3)])
def test_block_body_reads_nothing_back(scene, host_reads, scatter, views):
    """One block body (the rebin too, where it is inside the graph) on
    its static buffers, after the warm-up block, issues no operation that
    reads back to the host."""
    _, pcfg = _cfgs(scatter, 3, views_per_iteration=views)
    pcfg.compute.rebin_every = 1
    pprogs = mapper.MapperPrograms(pcfg, H, W, CAP)
    psurf, padam = _port_pool(scene["jsurf"], scene["jadam"])
    idx = torch.zeros((views,) if views > 1 else (), dtype=torch.long)
    static = mapper.StaticBlock(pprogs, psurf, padam, scene["pkf"], idx)
    static.start_block(idx)
    static.body()                        # the warm-up
    with host_reads:
        static.body()
    assert host_reads.found == []
    assert int(static.step) == int(padam.step) + 2


def test_gn_body_reads_nothing_back(host_reads):
    arrays, opts = _fixture("basin")
    inputs = [torch.tensor(a) for a in arrays]
    with host_reads:
        tracker.gauss_newton_align(*inputs, height=TH, width=TW, **opts)
    assert host_reads.found == []


def test_host_reads_sees_a_read():
    """The detector itself: an ``int()`` of a tensor, a boolean mask and
    a tensor made from host data are reads."""
    x = torch.arange(4.0)
    with HostReads() as mode:
        int(x.sum())
        x[x > 1.0]
        x.new_tensor([1.0])
    assert mode.found == ["aten._local_scalar_dense", "aten.index",
                          "aten.lift_fresh"]


# ---------------------------------------------------------------------------
# the GN loop on its static buffers
# ---------------------------------------------------------------------------

# gauss_newton_align's defaults, which the config's AlignerParams do not
# share
GN_DEFAULTS = dict(corr_factor_init=1.0, corr_decay_iters=0,
                   convergence_tol=0.0, lambda_range=0.0)


def _aligner(opts) -> tracker.AlignerGN:
    ap = {**GN_DEFAULTS, **opts}
    ap["max_correspondence_dist"] = ap.pop("max_corr_dist")
    cfg = pconfig.from_dict(pconfig.Configuration, {
        "preprocessing": {"image_height": TH, "image_width": TW},
        "tracking": {"method": "gsaligner", "gsaligner": ap},
        "logging": {"enable": False}})
    return tracker.AlignerGN(cfg, device="cpu")


@pytest.mark.parametrize("name", ["small", "range", "basin", "exit"])
def test_gn_program_body_matches_jax(name, monkeypatch):
    """AlignerGN's program body on its static buffers (loaded twice, with
    two guesses) against JAX's gauss_newton_align."""
    monkeypatch.setattr(graphs, "_check_device", lambda tensors: None)
    arrays, opts = _fixture(name)
    aligner = _aligner(opts)
    assert aligner.solver_settings() == {**GN_DEFAULTS, **opts}
    inputs = [torch.tensor(a) for a in arrays]
    prog = aligner._program(inputs, TH, TW)
    assert aligner._program(inputs, TH, TW) is prog
    guess = arrays[0].copy()
    guess[:3, 3] += [0.05, -0.02, 0.0]
    for T0 in (arrays[0], guess):
        prog.load(torch.tensor(T0), *inputs[1:])
        pT, pfit, _ = prog.body()
        jT, jfit = jtracker.gauss_newton_align(
            jnp.asarray(T0), *(jnp.asarray(a) for a in arrays[1:]),
            height=TH, width=TW, **opts)
        np.testing.assert_allclose(pT.numpy(), np.asarray(jT), atol=T_ATOL)
        assert abs(float(pfit) - float(jfit)) <= FIT_ATOL


# ---------------------------------------------------------------------------
# launch accounting, failed captures, kernels built before a capture
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_kernels(monkeypatch):
    """K1 and K3 with launchers that launch nothing and succeed."""
    for name in ("K1_fwd", "K3_ranksum"):
        monkeypatch.setattr(kernels.KERNELS[name], "_fn", lambda *a: 0)
        monkeypatch.setattr(kernels.KERNELS[name], "launches", 0)


def test_replay_adds_the_recorded_launches(monkeypatch, stub_kernels):
    monkeypatch.setattr(graphs, "_check_device", lambda tensors: None)
    monkeypatch.setattr(graphs, "_side_stream", contextlib.nullcontext)
    replays = []

    class Graph:
        def replay(self):
            replays.append(1)          # a replay issues no Python launch

    def record(body):
        return Graph(), body(), 4096

    monkeypatch.setattr(graphs, "_record", record)

    def body():
        kernels._launch("K1_fwd")
        kernels._launch("K3_ranksum")
        kernels._launch("K3_ranksum")
        return "out"

    prog = graphs.CapturedProgram("stub", body, [torch.zeros(3)],
                                  span="stub")
    counts = kernels.KERNELS
    assert prog.run() == "out"           # warm-up: direct launches count
    assert (counts["K1_fwd"].launches, counts["K3_ranksum"].launches) == \
        (1, 2)
    assert prog.launches == {"K1_fwd": 1, "K3_ranksum": 2}
    for n in range(1, 4):
        assert prog.run() == "out"
        assert (counts["K1_fwd"].launches,
                counts["K3_ranksum"].launches) == (1 + n, 2 + 2 * n)
    assert len(replays) == 3
    assert prog.stats() == dict(captures=1, replays=3, pool_bytes=4096,
                                static_bytes=12)


def test_failed_capture_raises(monkeypatch):
    monkeypatch.setattr(graphs, "_check_device", lambda tensors: None)
    monkeypatch.setattr(graphs, "_side_stream", contextlib.nullcontext)

    def record(body):
        raise RuntimeError("CUDA error: operation not permitted when "
                           "stream is capturing")

    monkeypatch.setattr(graphs, "_record", record)
    runs = []
    prog = graphs.CapturedProgram("mapper block (16, 256)",
                                  lambda: runs.append(1), [torch.zeros(1)],
                                  span="map.optimize")
    for _ in range(2):
        with pytest.raises(graphs.CaptureError,
                           match=r"capturing mapper block \(16, 256\) "
                                 r"failed: CUDA error: operation not "
                                 r"permitted"):
            prog.run()
    # each call ran its warm-up and nothing more: no uncaptured stand-in
    assert len(runs) == 2 and prog.graph is None and prog.replays == 0


def test_captured_program_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="uncaptured"):
        graphs.CapturedProgram("cpu", lambda: None, [torch.zeros(1)],
                               span="cpu")


def test_no_kernel_is_built_during_a_capture(monkeypatch):
    k = kernels.KERNELS["K2_bwd"]
    monkeypatch.setattr(k, "_fn", None)
    monkeypatch.setattr(kernels, "build_all", lambda: pytest.fail("built"))
    with kernels.recording(), pytest.raises(RuntimeError,
                                            match="K2_bwd is not built"):
        k.fn()
    assert kernels._RECORDS == []


def test_recordings_nest_and_count_nothing(stub_kernels):
    with kernels.recording() as outer:
        kernels._launch("K1_fwd")
        with kernels.recording() as inner:
            kernels._launch("K3_ranksum")
    assert outer == {"K1_fwd": 1} and inner == {"K3_ranksum": 1}
    assert kernels.KERNELS["K1_fwd"].launches == 0
    kernels.add_launches(inner)
    assert kernels.KERNELS["K3_ranksum"].launches == 1


# ---------------------------------------------------------------------------
# the debug checks run the loop uncaptured, and still raise
# ---------------------------------------------------------------------------

def test_debug_checks_take_the_uncaptured_loop(scene, monkeypatch):
    _, pcfg = _cfgs("ranksum", 3)
    pprogs = mapper.MapperPrograms(pcfg, H, W, CAP)
    said = []
    monkeypatch.setattr(mapper.logger, "info", said.append)
    cuda = torch.device("cuda")
    assert pprogs.captures_on(cuda) and not pprogs.captures_on(
        torch.device("cpu"))
    psurf, padam = _port_pool(scene["jsurf"], scene["jadam"])
    bad = psurf._replace(params=psurf.params._replace(
        xyz=torch.where(psurf.active[:, None], float("nan"),
                        psurf.params.xyz)))
    idx = torch.zeros((pprogs.n_blocks(),), dtype=torch.long)
    debug.enable_checks("nans")
    try:
        assert not pprogs.captures_on(cuda)
        assert not pprogs.captures_on(cuda)
        with pytest.raises((FloatingPointError, RuntimeError)):
            pprogs.optimize(bad, padam, scene["pkf"], idx)
    finally:
        debug.enable_checks("off")
    assert len(said) == 1 and "uncaptured" in said[0]
    assert pprogs.captures_on(cuda)
    assert debug.checked(lambda: pprogs.captures_on(cuda))() is False
    assert pprogs._graphs == {}


# ---------------------------------------------------------------------------
# checkpoints of both packages carry the step
# ---------------------------------------------------------------------------

def test_checkpoint_step_across_packages(tmp_path):
    """A port run's checkpoint, its step set to 4321, loads into the JAX
    package with that step; the JAX package's checkpoint of it loads back
    into the port with the step as a 0-d int32 tensor."""
    cfg_d = {"preprocessing": {"image_height": 16, "image_width": 128,
                               "depth_min": 0.5, "depth_max": 30.0},
             "mapping": {"num_iterations": 3, "densify_percentage": 0.1},
             "compute": {"initial_capacity": 4096},
             "logging": {"enable": False}}
    pcfg = pconfig.from_dict(pconfig.Configuration, cfg_d)
    pslam = SLAM(pcfg, device="cpu")
    pre = Preprocessor(pcfg, device="cpu")
    rng = np.random.default_rng(0)
    pslam.process(pre(synthetic.sensor_cloud(rng, np.eye(4), n=4000), 0.0,
                      gt_pose=np.eye(4)))
    model = pslam.local_models[-1]
    model.adam = model.adam._replace(step=S.adam_step_count(4321, "cpu"))
    checkpoint.save_checkpoint(tmp_path / "port", pslam)

    jcfg = jconfig.from_dict(jconfig.Configuration,
                             {**cfg_d, "compute": {"initial_capacity": 4096,
                                                   "backend": "jnp"}})
    js = jslam.SLAM(jcfg)
    jcheckpoint.load_checkpoint(tmp_path / "port", js)
    jstep = js.local_models[-1].adam.step
    assert jstep.dtype == jnp.int32 and int(jstep) == 4321
    jcheckpoint.save_checkpoint(tmp_path / "jax", js)

    back = SLAM(pcfg, device="cpu")
    checkpoint.load_checkpoint(tmp_path / "jax", back)
    step = back.local_models[-1].adam.step
    assert step.dtype == torch.int32 and step.dim() == 0
    assert int(step) == 4321


# ---------------------------------------------------------------------------
# on the card: captured against uncaptured
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: captured graphs run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """The captured paths against the uncaptured ones on the card, on the
    same inputs (chip_smoke.py phase 9 does the same at full width)."""

    def test_update_captured_equals_uncaptured(self, card, scene):
        _, pcfg = _cfgs("ranksum", 15)
        pprogs = mapper.MapperPrograms(pcfg, H, W, CAP)
        psurf, padam = _port_pool(scene["jsurf"], scene["jadam"])
        kf = scene["pkf"]
        kf = kf._replace(**{f: getattr(kf, f).to(card)
                            for f in ("K", "T_cw", "depth", "valid")})
        surf = S.Surfels(S.SurfelParams(*(p.to(card) for p in
                                          psurf.params)),
                         psurf.active.to(card))
        adam = S.AdamState(S.SurfelParams(*(p.to(card) for p in padam.mu)),
                           S.SurfelParams(*(p.to(card) for p in padam.nu)),
                           padam.step.to(card))
        idx = torch.ones((pprogs.n_blocks(),), dtype=torch.long,
                         device=card)
        kernels.reset_launch_counts()
        ref = pprogs.optimize(surf, adam, kf, idx, capture=False)
        n_ref = {k: v.launches for k, v in kernels.KERNELS.items()}
        kernels.reset_launch_counts()
        got = pprogs.optimize(surf, adam, kf, idx)
        assert {k: v.launches for k, v in kernels.KERNELS.items()} == n_ref
        assert got[3] == ref[3]
        assert int(got[1].step) == int(ref[1].step)
        for k in S.SurfelParams._fields:
            np.testing.assert_allclose(
                getattr(got[0].params, k).cpu().numpy(),
                getattr(ref[0].params, k).cpu().numpy(), atol=1e-4)
        (stats,) = pprogs.graph_stats().values()
        assert stats["captures"] == 1 and stats["replays"] > 0

    def test_gn_captured_equals_uncaptured(self, card):
        arrays, opts = _fixture("basin")
        aligner = _aligner(opts)
        aligner.device = card
        inputs = [torch.tensor(a, device=card) for a in arrays]
        ref_T, ref_fit = tracker.gauss_newton_align(*inputs, TH, TW, **opts)
        prog = aligner._program(inputs, TH, TW)
        for _ in range(3):
            T, fit, _ = prog(*inputs)
            np.testing.assert_allclose(T.cpu().numpy(), ref_T.cpu().numpy(),
                                       atol=1e-6)
            assert abs(float(fit) - float(ref_fit)) <= 1e-6
        assert prog.captures == 1 and prog.replays == 2
