"""K11 (splatloam_tpu_torch/csrc/image_loss.cu, ``kernels.image_loss``):
the mapper's image losses of each view and their cotangent for K2, and
the loss path around it (``api.render_loss``, ``cuda_raster._RasterLoss``,
the mapper's ``_loss``/``_loss_multi``).

On the CPU: K11's plain version (``_decode`` + ``image_losses`` and
autograd) in float32 against itself in float64, on synthetic renders with
pixels of alpha 0, invalid pixels, the border and degenerate normals; the
kernel's closed form, modelled here in torch (its two grids: each
pixel's normal and difference adjoints, then the gather), against the
plain version in float64; the loss and cotangent unchanged by the
keyframe's pose; and the mapper's loss through ``render_loss`` against
the composition it replaces (``render`` + ``image_losses``), bitwise for
one view; a program whose ``_image_losses`` is replaced takes the
replacement in K11's place.  The ``cuda`` tests hold the kernel against the plain version
on the card, the mapper's gradients through K11 against the composition,
a captured block against the uncaptured one, K11's launches against the
iterations run, and count the ATen operations one iteration issues.  On
a machine with a GPU and without JAX (``tests/conftest.py`` imports it):
``python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_image_loss.py``.
"""
import copy
from collections import Counter

import numpy as np
import pytest
import torch
from test_torch_profiling import _optimize_inputs, _run
from torch.utils._python_dispatch import TorchDispatchMode

from splatloam_tpu_torch import profiling
from splatloam_tpu_torch.geometry import se3, spherical
from splatloam_tpu_torch.model import surfels as S
from splatloam_tpu_torch.ops.rasterizer import binning, kernels
from splatloam_tpu_torch.ops.rasterizer.api import (image_losses, render,
                                                    render_batch, render_loss)
from splatloam_tpu_torch.slam.mapper import MapperPrograms, take

TILE = dict(tile_h=4, tile_w=16)
LAMBDAS = dict(lambda_normal=0.1, lambda_alpha=0.05)
# the plain version in float32 against float64: the loss within 1e-6
# relative, g within 1e-5 of its largest magnitude
LOSS_RTOL = 1e-6
G_TOL = 1e-5


def _intrinsics(height, width, dtype=torch.float32):
    """An OS-like spherical K: the whole azimuth circle, +-15 degrees."""
    vfov, phi_max = np.radians(30.0), np.radians(15.0)
    fy = -(height - 1) / vfov
    return torch.tensor([[width / (2 * np.pi), 0.0, width / 2.0 - 1.0],
                         [0.0, fy, -0.5 - fy * phi_max],
                         [0.0, 0.0, 1.0]], dtype=dtype)


def _pose(rng):
    """A random rigid transform [4, 4]."""
    q = rng.normal(size=4)
    R = se3.quat_to_rotmat(torch.tensor(q / np.linalg.norm(q),
                                        dtype=torch.float32)[None])[0]
    T = torch.eye(4)
    T[:3, :3] = R
    T[:3, 3] = torch.tensor(rng.normal(size=3) * 5.0, dtype=torch.float32)
    return T


def _scene(rng, b, height, width, device="cpu"):
    """Synthetic forward outputs of ``b`` views in the tiled layout, with
    keyframe depths and masks: a smooth range image, alpha in (0, 1) with
    a block of alpha 0, alpha 1 (clamped in Eq 16) and a block of alpha >
    0 with zero depth (degenerate normals), invalid pixels scattered and
    in a block.  -> (out [b*T, P, 8], depth, valid, K, T_cw)."""
    outs, depths, valids = [], [], []
    for _ in range(b):
        v, u = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        gt = 8.0 + 3.0 * np.sin(u * 2 * np.pi / width * 3) + 0.2 * v
        sd = gt + rng.normal(scale=0.05, size=gt.shape)
        alpha = rng.uniform(0.05, 0.999, size=gt.shape)
        alpha[2:6, 5:10] = 0.0
        alpha[-1, :4] = 1.0
        dsum = alpha * sd
        dsum[8:12, 20:26] = 0.0
        n = rng.normal(size=(*gt.shape, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        med = sd + rng.normal(scale=0.05, size=gt.shape)
        ch = np.concatenate([dsum[..., None], alpha[..., None],
                             alpha[..., None] * n, med[..., None],
                             rng.uniform(size=gt.shape)[..., None],
                             (1.0 - alpha)[..., None]], -1)
        valid = rng.uniform(size=gt.shape) < 0.85
        valid[10:14, 40:50] = False
        img = torch.tensor(ch, dtype=torch.float32)
        outs.append(binning.tile_image(img, **TILE))
        depths.append(torch.tensor(gt, dtype=torch.float32))
        valids.append(torch.tensor(valid))
    K = _intrinsics(height, width)[None].repeat(b, 1, 1)
    T_cw = torch.stack([_pose(rng) for _ in range(b)])
    return tuple(x.to(device) for x in (
        torch.cat(outs), torch.stack(depths), torch.stack(valids), K, T_cw))


def _f64(*ts):
    return tuple(t.double() if t.is_floating_point() else t for t in ts)


def _kernel_model(out, depth, valid, K, *, tile_h, tile_w, lambda_normal,
                  lambda_alpha, depth_ratio):
    """csrc/image_loss.cu's arithmetic in torch, camera frame: the first
    grid's per-pixel normal and difference adjoints and the loss sums,
    then the second grid's gather into each pixel's cotangent."""
    b, height, width = depth.shape
    ch = kernels.out_channels(out.reshape(b, -1, *out.shape[1:]), height,
                              width, tile_h, tile_w)
    D, A, N, M = ch["depth_sum"], ch["alpha"], ch["normal_sum"], ch["median"]
    med = depth_ratio > 0
    r = depth_ratio
    mask = A > 0
    sa = torch.where(mask, A, 1.0)
    rn = torch.where(mask[..., None], N / sa[..., None], 0.0)
    de = torch.where(mask, D / sa, 0.0)
    sd = de * (1.0 - r) + M * r if med else de
    w = valid.to(D.dtype)
    rays = torch.stack([spherical.pixel_rays(K[v], height, width)
                        for v in range(b)]).to(D.dtype)
    pts = sd[..., None] * rays
    dx = pts[:, 2:, 1:-1] - pts[:, :-2, 1:-1]
    dy = pts[:, 1:-1, 2:] - pts[:, 1:-1, :-2]
    nr = torch.linalg.cross(dy, dx, dim=-1)
    n2 = torch.sum(nr * nr, -1, keepdim=True)
    ok = n2 > 1e-24
    s = torch.sqrt(torch.where(ok, n2, 1.0))
    n_in = torch.where(ok, nr / s, 0.0)
    inner = (slice(None), slice(1, -1), slice(1, -1))
    gn = (-lambda_normal * w[inner] * A[inner])[..., None] * rn[inner]
    gr = torch.where(ok, (gn - torch.sum(n_in * gn, -1, keepdim=True)
                          * n_in) / s, 0.0)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))

    n = pad(n_in)
    gdx = pad(torch.linalg.cross(gr, dy, dim=-1))
    gdy = pad(torch.linalg.cross(dx, gr, dim=-1))
    hw = (1, 2)
    a = torch.clamp(A, 1e-7, 1.0 - 1e-7)
    nv = torch.clamp(torch.sum(w, hw), min=1.0)
    loss = (torch.sum(torch.abs(w * (sd - depth)), hw) / (height * width)
            + torch.sum(-torch.log(a) * w, hw) / nv * lambda_alpha
            + torch.sum((1.0 - torch.sum(rn * A[..., None] * n, -1)) * w,
                        hw) / nv * lambda_normal)
    gp = torch.zeros_like(pts)
    gp[:, 1:] += gdx[:, :-1]
    gp[:, :-1] -= gdx[:, 1:]
    gp[:, :, 1:] += gdy[:, :, :-1]
    gp[:, :, :-1] -= gdy[:, :, 1:]
    inv = (1.0 / nv)[:, None, None]
    x = w * (sd - depth)
    g_sd = torch.sum(rays * gp, -1) * inv + w * torch.sign(x) / (height
                                                                * width)
    c = -lambda_normal * inv * w
    g_rn = c[..., None] * (A[..., None] * n)
    g_A = c * torch.sum(rn * n, -1)
    inb = (A >= 1e-7) & (A <= 1.0 - 1e-7)
    g_A = g_A - torch.where(inb, lambda_alpha * inv * w / sa, 0.0)
    g_de = (1.0 - r) * g_sd if med else g_sd
    g_D = torch.where(mask, g_de / sa, 0.0)
    g_N = torch.where(mask[..., None], g_rn / sa[..., None], 0.0)
    g_A = g_A - torch.where(mask, (g_de * D + torch.sum(g_rn * N, -1))
                            / (sa * sa), 0.0)
    g_M = r * g_sd if med else torch.zeros_like(g_sd)
    zero = torch.zeros_like(g_sd)
    g_img = torch.cat([g_D[..., None], g_A[..., None], g_N, g_M[..., None],
                       zero[..., None], zero[..., None]], -1)
    g = torch.cat([binning.tile_image(g_img[v], tile_h, tile_w)
                   for v in range(b)])
    return loss, g


def _g_err(g, ref, ties=None):
    """max |g - ref| over max |ref|, over the pixels not in ``ties``."""
    d = (g - ref).abs()
    if ties is not None:
        d = torch.where(ties[..., None], 0.0, d)
    return float(d.max()) / float(ref.abs().max())


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("depth_ratio", [0.0, 0.5])
def test_plain_version_against_float64(b, depth_ratio):
    rng = np.random.default_rng(10 * b + int(depth_ratio * 2))
    out, depth, valid, K, T_cw = _scene(rng, b, 16, 64)
    kw = dict(**TILE, **LAMBDAS, depth_ratio=depth_ratio)
    loss, g = kernels.image_loss_plain(out, depth, valid, K, T_cw, **kw)
    loss64, g64 = kernels.image_loss_plain(*_f64(out, depth, valid, K, T_cw),
                                           **kw)
    assert loss.shape == (b,) and g.shape == out.shape
    np.testing.assert_allclose(loss.numpy(), loss64.numpy(), rtol=LOSS_RTOL)
    ties = kernels.image_loss_ties(out, depth, valid, **kw)
    assert _g_err(g.double(), g64, ties) <= G_TOL
    # final T and the distortion take nothing; the median only with
    # depth_ratio > 0
    assert not g[..., 6:].any()
    assert bool(g[..., 5].any()) == (depth_ratio > 0)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("depth_ratio", [0.0, 0.5])
def test_kernel_closed_form_against_plain_version(b, depth_ratio):
    """The arithmetic image_loss.cu implements, in float64, equals the
    decode's autograd: the stencil's gather and the border, the
    degenerate normals, the clamp and the masks included."""
    rng = np.random.default_rng(20 + b)
    out, depth, valid, K, _ = _f64(*_scene(rng, b, 16, 64))
    kw = dict(**TILE, **LAMBDAS, depth_ratio=depth_ratio)
    loss, g = _kernel_model(out, depth, valid, K, **kw)
    # the camera frame on both sides: a float32 pose is a rotation only to
    # its rounding
    eye = torch.eye(4, dtype=torch.float64).repeat(b, 1, 1)
    loss_p, g_p = kernels.image_loss_plain(out, depth, valid, K, eye, **kw)
    np.testing.assert_allclose(loss.numpy(), loss_p.numpy(), rtol=1e-12)
    assert _g_err(g, g_p) <= 1e-10


def test_scene_has_the_cases():
    """The synthetic renders hold what the tests above are to cover:
    alpha 0 (no cotangent at all), alpha clamped in Eq 16, invalid
    pixels and degenerate normals where alpha > 0."""
    out, depth, valid, K, T_cw = _f64(*_scene(np.random.default_rng(0), 1,
                                              16, 64))
    ch = kernels.out_channels(out[None], 16, 64, **TILE)
    a = ch["alpha"][0]
    assert (a == 0).sum() >= 9 and (a == 1).sum() >= 1
    assert (~valid).sum() >= 40
    sd = torch.where(a > 0, ch["depth_sum"][0] / torch.where(a > 0, a, 1.0),
                     0.0)
    n = spherical.depth_to_normal(sd, K[0])
    assert not n[9:11, 21:25].any() and (a[9:11, 21:25] > 0).all()
    _, g = kernels.image_loss_plain(out, depth, valid, K, T_cw, **TILE,
                                    **LAMBDAS, depth_ratio=0.5)
    g_img = binning.untile_px(g[None], 16, 64, **TILE)[0]
    assert not g_img[:5, 2:6, 5:10].any() and g_img[5, 2:6, 5:10].any()
    assert g_img[:, 9:11, 21:25].abs().sum() > 0


def test_loss_does_not_depend_on_the_pose():
    rng = np.random.default_rng(3)
    out, depth, valid, K, T_cw = _f64(*_scene(rng, 2, 16, 64))
    kw = dict(**TILE, **LAMBDAS, depth_ratio=0.5)
    loss, g = kernels.image_loss_plain(out, depth, valid, K, T_cw, **kw)
    eye = torch.eye(4, dtype=torch.float64).repeat(2, 1, 1)
    loss_c, g_c = kernels.image_loss_plain(out, depth, valid, K, eye, **kw)
    np.testing.assert_allclose(loss.numpy(), loss_c.numpy(), rtol=1e-6)
    assert _g_err(g_c, g) <= 1e-5


@pytest.fixture(scope="module")
def slam_cpu(tmp_path_factory):
    slam = _run(tmp_path_factory.mktemp("k11"), "cpu")
    return slam, profiling.get_profiler()


def _composition_loss(progs, kf, params, active, kf_idx, tiles):
    """The mapper's loss as the composition K11 replaces: the render
    package, then the image losses (a mean over views)."""
    scaling = torch.exp(params.log_scale)
    opacity = torch.sigmoid(params.logit_opacity) * active
    one = kf_idx.dim() == 0
    pkg = (render if one else render_batch)(
        params.xyz, scaling, params.quat, opacity, take(kf.T_cw, kf_idx),
        take(kf.K, kf_idx), progs.params, progs.cfg.opt.depth_ratio,
        tiles=tiles)
    loss = progs._image_losses(pkg, take(kf.depth, kf_idx),
                               take(kf.valid, kf_idx))
    return (loss if one else torch.mean(loss)) + progs._scale_penalty(
        scaling, active)


def _grads(fn, surf):
    p = S.SurfelParams(*(x.detach().requires_grad_(True)
                         for x in surf.params))
    loss = fn(p)
    return loss.detach(), torch.autograd.grad(loss, p)


def _loss_pair(slam, views):
    """(the mapper's loss and gradients, the composition's) on the
    newest submap's pool and its keyframes (``views`` views)."""
    progs, model, kf, idx = _optimize_inputs(slam)
    progs = copy.copy(progs)
    progs.views = views
    kf_idx = idx[0] if views == 1 else torch.arange(
        views, device=idx.device) % len(model.keyframes)
    surf = model.surfels
    tiles = progs.make_tiles(surf, kf, kf_idx)
    loss_fn = progs._loss if views == 1 else progs._loss_multi
    got = _grads(lambda p: loss_fn(p, surf.active, kf, kf_idx, tiles), surf)
    ref = _grads(lambda p: _composition_loss(progs, kf, p, surf.active,
                                             kf_idx, tiles), surf)
    return got, ref


def _replaced_loss_pair(slam):
    """(the mapper's loss and gradients, the composition's, K11's
    launches in the first) with ``_image_losses`` replaced on the
    program (as the benchmark's half_batch fault replaces it): the
    iteration must take the replacement, not K11."""
    progs, model, kf, idx = _optimize_inputs(slam)
    progs = copy.copy(progs)

    def doubled(pkg, gt_depth, valid):
        return 2.0 * MapperPrograms._image_losses(progs, pkg, gt_depth,
                                                  valid)
    progs._image_losses = doubled
    surf = model.surfels
    tiles = progs.make_tiles(surf, kf, idx[0])
    kernels.reset_launch_counts()
    got = _grads(lambda p: progs._loss(p, surf.active, kf, idx[0], tiles),
                 surf)
    launches = kernels.KERNELS["K11_image_loss"].launches
    ref = _grads(lambda p: _composition_loss(progs, kf, p, surf.active,
                                             idx[0], tiles), surf)
    return got, ref, launches


def test_replaced_image_losses_are_taken(slam_cpu):
    (loss, grads), (loss_r, grads_r), _ = _replaced_loss_pair(slam_cpu[0])
    (plain, _), _ = _loss_pair(slam_cpu[0], 1)
    assert torch.equal(loss, loss_r) and not torch.equal(loss, plain)
    for g, g_r in zip(grads, grads_r):
        assert torch.equal(g, g_r)


def test_mapper_loss_is_the_composition_on_one_view(slam_cpu):
    (loss, grads), (loss_r, grads_r) = _loss_pair(slam_cpu[0], 1)
    assert torch.equal(loss, loss_r)
    for g, g_r in zip(grads, grads_r):
        assert torch.equal(g, g_r)


def test_mapper_loss_is_the_composition_on_three_views(slam_cpu):
    """The mean over views is K11's 1/B cotangent: float order only."""
    (loss, grads), (loss_r, grads_r) = _loss_pair(slam_cpu[0], 3)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-7)
    for g, g_r in zip(grads, grads_r):
        assert _g_err(g, g_r) <= 1e-6


def test_eager_render_loss_is_render_and_losses(slam_cpu):
    progs, model, kf, idx = _optimize_inputs(slam_cpu[0])
    s = model.surfels
    params = progs.params._replace(backend="eager")
    i = int(idx[0])
    args = (s.params.xyz, s.scaling, s.rotation, s.opacity, kf.T_cw[i],
            kf.K[i])
    loss = render_loss(*args, kf.depth[i], kf.valid[i], params, **LAMBDAS)
    ref = image_losses(render(*args, params), kf.depth[i], kf.valid[i],
                       **LAMBDAS)
    assert torch.equal(loss, ref)


def test_updates_count_the_image_loss_launches(slam_cpu):
    """Each update adds its K11 launches to ``kernel.K11_image_loss``:
    none on the CPU, where the plain version runs."""
    prof = slam_cpu[1]
    counts = [c for c in prof.counts() if c.name == "kernel.K11_image_loss"]
    updates = {s.frame for s in prof.spans() if s.name == "map_update"}
    assert {c.frame for c in counts} == updates and len(counts) == len(
        updates)
    assert all(c.value == 0 for c in counts)
    assert "kernel.K11_image_loss" in prof.report()


def test_processed_sweeps_keep_no_normal_map(slam_cpu):
    """``SLAM.frames`` keeps each processed sweep's range image and mask
    (the benchmark's comparison reads them), the keyframes' whole
    camera, and no other sweep's normal map."""
    slam = slam_cpu[0]
    kfs = {id(k) for m in slam.local_models for k in m.keyframes}
    assert 0 < len(kfs) < len(slam.frames)
    for f in slam.frames:
        assert f.camera.depth is not None and f.camera.valid is not None
        assert (f.camera.normal is not None) == (id(f) in kfs)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K11 is a CUDA kernel")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def slam_card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K11 is a CUDA kernel")
    slam = _run(tmp_path_factory.mktemp("k11card"), torch.device("cuda"))
    return slam, profiling.get_profiler()


class _OpCount(TorchDispatchMode):
    """ATen operators issued, views and metadata excepted."""
    SKIP = ("view", "_unsafe_view", "reshape", "expand", "as_strided",
            "detach", "alias", "t", "transpose", "permute", "squeeze",
            "unsqueeze", "select", "slice", "movedim", "unbind", "split")

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in self.SKIP:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
class TestOnCard:

    @pytest.mark.parametrize("b,height,width", [(1, 16, 256), (3, 16, 256),
                                                (1, 128, 1024)])
    @pytest.mark.parametrize("depth_ratio", [0.0, 0.5])
    def test_kernel_against_plain_version(self, card, b, height, width,
                                          depth_ratio):
        """K11 against the plain version in float64 on the card: the loss
        within 1e-5 relative, g within 1e-4 of its largest entry, the
        depth L1's ties (``kernels.image_loss_ties``) apart."""
        rng = np.random.default_rng(b * height + int(depth_ratio * 2))
        args = _scene(rng, b, height, width, card)
        kw = dict(**TILE, **LAMBDAS, depth_ratio=depth_ratio)
        kernels.reset_launch_counts()
        loss, g = kernels.image_loss(*args, **kw)
        assert kernels.KERNELS["K11_image_loss"].launches == 1
        loss64, g64 = kernels.image_loss_plain(*_f64(*args), **kw)
        np.testing.assert_allclose(loss.cpu().numpy(), loss64.cpu().numpy(),
                                   rtol=1e-5)
        ties = kernels.image_loss_ties(*args[:3], **kw)
        assert int(ties.sum()) < 0.01 * ties.numel()
        assert _g_err(g.double(), g64, ties) <= 1e-4
        # deterministic: no float atomics
        loss2, g2 = kernels.image_loss(*args, **kw)
        assert torch.equal(loss, loss2) and torch.equal(g, g2)

    @pytest.mark.parametrize("views", [1, 3])
    def test_mapper_gradients_through_the_kernel(self, slam_card, views):
        """The four parameter gradients of one iteration's loss through
        K11 against the composition's on the card (the repo's gradient
        tolerance, 2e-3 of the largest: K2's 1/(1 - alpha) magnifies the
        cotangent's float order)."""
        (loss, grads), (loss_r, grads_r) = _loss_pair(slam_card[0], views)
        np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
        for g, g_r in zip(grads, grads_r):
            assert _g_err(g, g_r) <= 2e-3

    def test_captured_block_equals_uncaptured(self, slam_card):
        """Two 16-iteration blocks, captured (the first with its capture,
        the second replayed) and uncaptured: the pools at the repo's pool
        tolerance (1e-4 plus each field's learning rate per Adam step),
        K11 launched once an iteration either way."""
        progs, model, kf, idx = _optimize_inputs(slam_card[0])
        cfg = copy.deepcopy(slam_card[0].cfg)
        cfg.mapping.num_iterations = 31
        cfg.compute.rebin_every = 16
        progs = MapperPrograms(cfg, progs.height, progs.width, progs.capacity)
        idx = idx.new_zeros((progs.n_blocks(),)) + idx[0]
        runs = []
        for capture in (False, True):
            kernels.reset_launch_counts()
            s, a, ema, iters = progs.optimize(model.surfels, model.adam, kf,
                                              idx, capture=capture)
            torch.cuda.synchronize()
            runs.append((s, a, float(ema), iters,
                         kernels.KERNELS["K11_image_loss"].launches))
        (s0, a0, e0, it0, n0), (s1, a1, e1, it1, n1) = runs
        assert it0 == it1 == 32 and n0 == n1 == 32
        assert int(a0.step) == int(a1.step)
        np.testing.assert_allclose(e1, e0, rtol=1e-3)
        oc = cfg.opt
        lrs = {"xyz": oc.position_lr, "log_scale": oc.scaling_lr,
               "quat": oc.rotation_lr, "logit_opacity": oc.opacity_lr}
        act = s0.active
        for k in S.SurfelParams._fields:
            np.testing.assert_allclose(
                getattr(s1.params, k)[act].cpu().numpy(),
                getattr(s0.params, k)[act].cpu().numpy(),
                atol=1e-4 + lrs[k] * 32, err_msg=k)

    def test_replaced_image_losses_are_taken(self, slam_card):
        """A program whose ``_image_losses`` was replaced renders and
        takes the replacement on the card too, and launches no K11."""
        (loss, grads), (loss_r, grads_r), launches = _replaced_loss_pair(
            slam_card[0])
        assert launches == 0
        # the same operations twice: float order at most (the tolerances
        # of test_mapper_gradients_through_the_kernel)
        np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-6)
        for g, g_r in zip(grads, grads_r):
            assert _g_err(g, g_r) <= 2e-3

    def test_launches_equal_the_iterations_run(self, slam_card):
        """Over the card's run every optimize iteration launched K11 once,
        and each update's counter holds its launches."""
        slam, prof = slam_card
        counts = [c.value for c in prof.counts()
                  if c.name == "kernel.K11_image_loss"]
        assert len(counts) == 2 and all(c > 0 for c in counts)
        assert prof.counters["kernel.K11_image_loss"] == sum(counts)
        progs, model, kf, idx = _optimize_inputs(slam)
        kernels.reset_launch_counts()
        _, _, _, iters = progs.optimize(model.surfels, model.adam, kf, idx)
        torch.cuda.synchronize()
        assert kernels.KERNELS["K11_image_loss"].launches == iters

    def test_iteration_issues_fewer_operations(self, slam_card):
        """One optimize iteration through K11 against one through the
        composition, by ATen operators: at least 150 fewer, and none of
        the decode's."""
        progs, model, kf, idx = _optimize_inputs(slam_card[0])
        surf, adam = model.surfels, model.adam
        tiles = progs.make_tiles(surf, kf, idx[0])

        def composition_iter():
            p = S.SurfelParams(*(x.detach().requires_grad_(True)
                                 for x in surf.params))
            loss = _composition_loss(progs, kf, p, surf.active, idx[0],
                                     tiles)
            g = S.SurfelParams(*torch.autograd.grad(loss, p))
            return S.adam_step(surf, adam, g, progs.hyper)

        counts = []
        for it in (lambda: progs.one_iter(surf, adam, kf, idx[0], tiles),
                   composition_iter):
            it()
            with _OpCount() as mode:
                it()
            counts.append(mode.ops)
        new, old = counts
        print(f"ATen operators an iteration: {sum(new.values())} through "
              f"K11, {sum(old.values())} through the composition")
        assert sum(old.values()) - sum(new.values()) >= 150
        assert new["linalg_cross"] == 0 and old["linalg_cross"] > 0
