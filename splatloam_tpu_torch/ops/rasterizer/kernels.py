"""The rasterizer's hand-written CUDA kernels, their wrappers and their
plain PyTorch versions.

  K1 raster_fwd        <- splatloam_tpu/ops/rasterizer/pallas_raster.py:
                          _fwd_kernel
  K2 raster_bwd        <- pallas_raster.py:_bwd_kernel (fused=False)
  K3 ranksum_rows      <- pallas_raster.py:_ranksum_kernel
  K4 scatter_rows      <- pallas_raster.py:_scatter_rows_kernel
  K5 raster_bwd_fused  <- pallas_raster.py:_bwd_kernel (fused=True)
  K6 scatter_overflow  <- pallas_raster.py:_scatter_overflow_kernel
  K7 raster_fwd_flat   <- pallas_raster.py:_fwd_kernel_flat
  K8 raster_bwd_flat   <- pallas_raster.py:_bwd_kernel_flat
  K9 scatter_rows_flat <- pallas_raster.py:_scatter_rows_kernel_flat
  K10 scatter_rows_tps <- pallas_raster.py:_scatter_rows_kernel_batched

Each wrapper takes the plain version only for tensors that lie on the CPU;
for CUDA tensors it launches its kernel (built at first use from
``splatloam_tpu_torch/csrc/*.cu`` with nvcc into ``build/splatloam_tpu_torch``
and loaded with ctypes) or raises.  ``KERNELS[name].launches`` counts the
kernel's launches, and nothing else.

Shapes (one view): F [N+1, 16] packed features (row N is the zero pad
row), lists [T, K] int32 slot ids, counts [T] int32, rays [T, P, 3],
pix [T, P, 2], out [T, P, 8] = (depth_sum, alpha, normal_sum[3], median,
dist, final_T), tbound [T, P, K/chunk] chunk-start transmittance (0 for
chunks the forward skipped), g [T, P, 8] output cotangents, dFg [T, K, 16]
per-slot feature gradients, dF [N+1, 16] per-surfel feature gradients.
Several views share one launch through a pool F [B*(N+1), 16] whose
slot ids carry each view's row offset.

Flat layout (K7-K9): ids [B*E] int32 slot ids into the pool (pads name a
view's zero row N), starts [B, T+1] int32 chunk-aligned segment starts of
each view's E slots, tbound [B*E/chunk, P] per flat chunk, rows [B*E, 16]
per flat slot.  Tile t of view v owns the chunks [starts[v, t],
starts[v, t+1]); budget chunks past starts[v, T] belong to no tile, and
K9 sums the rows of the owned slots that are not pads only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

from .common import (ALPHA_MAX, ALPHA_MIN, FILTER_INV_SQUARE, NEAR,
                     T_EPS)

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "splatloam_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
# the forward's and the backward's bodies check a tile's liveness over
# its pixels in one block, and walk slots in 32-slot segments
MAX_TILE_PIXELS = 256
SUB = 32
MAX_CHUNK = 1024


@dataclass
class Kernel:
    """One CUDA kernel: its source, C entry point and launch count."""
    name: str
    source: str        # file under csrc/
    symbol: str        # extern "C" launcher
    argtypes: tuple
    replaces: str      # TPU kernel it ports (file:line)
    launches: int = 0
    _fn: object = None

    def fn(self):
        if self._fn is None:
            build_all()
        return self._fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TPU = "splatloam_tpu/ops/rasterizer/pallas_raster.py"
KERNELS = {
    "K1_fwd": Kernel(
        "K1_fwd", "raster_fwd.cu", "launch_raster_fwd",
        (_P,) * 7 + (_I,) * 4 + (_F, _F) + (_I, _I, _P),
        f"{_TPU}:159"),
    "K2_bwd": Kernel(
        "K2_bwd", "raster_bwd.cu", "launch_raster_bwd",
        (_P,) * 9 + (_I,) * 4 + (_F, _F) + (_I, _P),
        f"{_TPU}:267"),
    "K3_ranksum": Kernel(
        "K3_ranksum", "ranksum.cu", "launch_ranksum_rows",
        (_P,) * 5 + (_I, _P), f"{_TPU}:728"),
    "K4_scatter_rows": Kernel(
        "K4_scatter_rows", "scatter_rows.cu", "launch_scatter_rows",
        (_P,) * 4 + (_I, _I, _P), f"{_TPU}:478"),
    "K5_bwd_fused": Kernel(
        "K5_bwd_fused", "raster_bwd_fused.cu", "launch_raster_bwd_fused",
        (_P,) * 9 + (_I,) * 4 + (_F, _F) + (_I, _P),
        f"{_TPU}:267"),
    "K6_scatter_overflow": Kernel(
        "K6_scatter_overflow", "scatter_overflow.cu",
        "launch_scatter_overflow", (_P,) * 5 + (_I, _P), f"{_TPU}:605"),
    "K7_fwd_flat": Kernel(
        "K7_fwd_flat", "raster_fwd_flat.cu", "launch_raster_fwd_flat",
        (_P,) * 7 + (_I,) * 5 + (_F, _F) + (_I, _I, _P),
        f"{_TPU}:1087"),
    "K8_bwd_flat": Kernel(
        "K8_bwd_flat", "raster_bwd_flat.cu", "launch_raster_bwd_flat",
        (_P,) * 9 + (_I,) * 5 + (_F, _F) + (_I, _P),
        f"{_TPU}:1153"),
    "K9_scatter_rows_flat": Kernel(
        "K9_scatter_rows_flat", "scatter_rows_flat.cu",
        "launch_scatter_rows_flat", (_P,) * 4 + (_I,) * 4 + (_P,),
        f"{_TPU}:1272"),
    "K10_scatter_rows_tps": Kernel(
        "K10_scatter_rows_tps", "scatter_rows.cu", "launch_scatter_rows",
        (_P,) * 4 + (_I, _I, _P), f"{_TPU}:511"),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ at first use on a GPU machine")
    return found


def _library_path(source: str) -> Path:
    """Build output keyed by the sources and flags, so an edit rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / source]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, tuple[float, str]]:
    """Compile every kernel source that is not built yet, one nvcc per
    source, all started together; load each library.  Returns the build
    seconds and the compiler's log (ptxas' registers, stack frame and
    spills per kernel) of each compiled source."""
    import time
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for k in KERNELS.values():
        out = _library_path(k.source)
        if k.source not in jobs and not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o",
                   str(tmp), str(CSRC_DIR / k.source)]
            jobs[k.source] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
    built = {}
    errors = []
    for source, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        built[source] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {source}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS.values():
        if k._fn is None:
            lib = ctypes.CDLL(str(_library_path(k.source)))
            fn = getattr(lib, k.symbol)
            fn.argtypes = list(k.argtypes)
            fn.restype = ctypes.c_int
            k._fn = fn
    return built


def resident_warps(name: str, p_tile: int, chunk: int, with_dist: bool,
                   with_median: bool = False) -> int:
    """Resident warps per SM of kernel ``name`` (a forward, "K1_fwd" or
    "K7_fwd_flat", or a backward, "K2_bwd", "K5_bwd_fused" or
    "K8_bwd_flat") at these shapes, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    k = KERNELS[name]
    k.fn()
    fn = getattr(ctypes.CDLL(str(_library_path(k.source))),
                 f"{k.symbol}_resident_warps")
    args = (p_tile, chunk, int(with_dist))
    if name in ("K1_fwd", "K7_fwd_flat"):
        args = (p_tile, chunk, int(with_median), int(with_dist))
    fn.argtypes = [_I] * len(args)
    fn.restype = ctypes.c_int
    n = fn(*args)
    if n < 0:
        raise RuntimeError(f"{name}: CUDA error {-n} in the occupancy query")
    return n


def _launch(name: str, *args) -> None:
    k = KERNELS[name]
    err = k.fn()(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    k.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, t: torch.Tensor, dtype, shape, device,
           align: int = 16) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: the kernels run on "
                     "CUDA, their plain versions on the CPU")


def _check_tiles(F, lists, counts, rays, pix, chunk):
    n_tiles, k_cap = lists.shape
    p_tile = rays.shape[1]
    dev = F.device
    _check("F", F, torch.float32, (F.shape[0], 16), dev)
    _check("lists", lists, torch.int32, (n_tiles, k_cap), dev)
    _check("counts", counts, torch.int32, (n_tiles,), dev)
    _check("rays", rays, torch.float32, (n_tiles, p_tile, 3), dev)
    _check("pix", pix, torch.float32, (n_tiles, p_tile, 2), dev)
    if p_tile % 32 or p_tile > MAX_TILE_PIXELS:
        raise ValueError(f"tile of {p_tile} pixels: the kernels take a "
                         f"multiple of 32 up to {MAX_TILE_PIXELS}")
    if chunk % SUB or chunk > MAX_CHUNK or k_cap % chunk:
        raise ValueError(f"chunk {chunk} must be a multiple of {SUB} up "
                         f"to {MAX_CHUNK} dividing the list capacity {k_cap}")
    return n_tiles, k_cap, p_tile


# ---------------------------------------------------------------------------
# shared per-(pixel, slot) geometry of the plain versions
# ---------------------------------------------------------------------------

def _splat_geometry(Fc, rays, pix, width: int) -> dict:
    """Fc [T, C, 16] chunk features; rays [T, P, 3]; pix [T, P, 2] ->
    dict of [T, P, C] (and [T, 1, C]) arrays, as the TPU kernel's
    ``_splat_geometry``."""
    f = Fc.transpose(1, 2)[:, :, None, :]             # [T, 16, 1, C]
    p3, gu3, gv3, n3 = f[:, 0:3], f[:, 3:6], f[:, 6:9], f[:, 9:12]
    opa, depth_c, cx, cy = f[:, 12], f[:, 13], f[:, 14], f[:, 15]
    r = rays.transpose(1, 2)[..., None]                # [T, 3, P, 1]

    def dotr(a):
        return r[:, 0] * a[:, 0] + r[:, 1] * a[:, 1] + r[:, 2] * a[:, 2]

    A1, A2, A3 = dotr(gu3), dotr(gv3), dotr(n3)
    np_ = torch.sum(n3 * p3, dim=1)                    # [T, 1, C]
    pgu = torch.sum(p3 * gu3, dim=1)
    pgv = torch.sum(p3 * gv3, dim=1)

    denom = torch.where(torch.abs(A3) < 1e-8, 1e-8, A3)
    tstar = np_ / denom
    uu = tstar * A1 - pgu
    vv = tstar * A2 - pgv
    rho3 = uu * uu + vv * vv

    dx = pix[:, :, 0:1] - cx
    dx = dx - torch.round(dx * (1.0 / width)) * width
    dy = pix[:, :, 1:2] - cy
    rho2 = FILTER_INV_SQUARE * (dx * dx + dy * dy)

    use2 = rho2 < rho3
    rho = torch.where(use2, rho2, rho3)
    m = torch.where(use2, depth_c, tstar)
    g_exp = torch.exp(-0.5 * rho)
    alpha_raw = opa * g_exp
    ok = (tstar > NEAR) & (alpha_raw >= ALPHA_MIN)
    alpha = torch.where(ok, torch.clamp(alpha_raw, max=ALPHA_MAX), 0.0)
    return dict(p3=p3[..., 0, :], gu3=gu3[..., 0, :], gv3=gv3[..., 0, :],
                n3=n3[..., 0, :], A1=A1, A2=A2, A3=denom, tstar=tstar,
                uu=uu, vv=vv, use2=use2, m=m, g_exp=g_exp,
                alpha_raw=alpha_raw, alpha=alpha, ok=ok, dx=dx, dy=dy)


def _excl_cumsum(x):
    return torch.cumsum(x, dim=-1) - x


def _strict_suffix_sum(x):
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), dim=-1), (-1,)) - x


def _n_active_chunks(counts, chunk):
    return (counts.long() + chunk - 1) // chunk


# ---------------------------------------------------------------------------
# K1: forward
# ---------------------------------------------------------------------------

def raster_fwd_plain(F, lists, counts, rays, pix, *, chunk: int,
                     width: int, with_median: bool, with_dist: bool):
    """Plain version of K1: a tile-batched loop over chunks, each chunk
    composited in closed form (exclusive cumsum of log1p(-alpha)); a tile
    stops at its count or once every pixel's T <= T_EPS."""
    n_tiles, k_cap = lists.shape
    p_tile = rays.shape[1]
    n_chunks = k_cap // chunk
    n_act = _n_active_chunks(counts, chunk)
    zeros = rays.new_zeros((n_tiles, p_tile))
    T_carry = torch.ones_like(zeros)
    d_sum, a_sum, med, dist = (zeros.clone() for _ in range(4))
    n_sum = rays.new_zeros((n_tiles, p_tile, 3))
    tbound = rays.new_zeros((n_tiles, p_tile, n_chunks))
    for i in range(n_chunks):
        act = (i < n_act) & (T_carry.amax(dim=1) > T_EPS)      # [T]
        if not bool(act.any()):
            break
        a1 = act[:, None]
        tbound[:, :, i] = torch.where(a1, T_carry, 0.0)
        Fc = F[lists[:, i * chunk:(i + 1) * chunk].long()]      # [T, C, 16]
        geo = _splat_geometry(Fc, rays, pix, width)
        alpha, m = geo["alpha"], geo["m"]
        logs = torch.log1p(-alpha)
        Ti = T_carry[..., None] * torch.exp(_excl_cumsum(logs))
        w = alpha * Ti
        wm = w * m
        if with_dist:
            a_prev = a_sum[..., None] + _excl_cumsum(w)
            d_prev = d_sum[..., None] + _excl_cumsum(wm)
            dist = torch.where(a1, dist + torch.sum(
                w * (m * a_prev - d_prev), dim=-1), dist)
        if with_median:
            crossing = (Ti > 0.5) & (Ti * (1.0 - alpha) <= 0.5) & (alpha > 0)
            first = crossing & (torch.cumsum(crossing.int(), dim=-1) == 1)
            d_first = torch.sum(torch.where(first, m, 0.0), dim=-1)
            any_c = first.any(dim=-1)
            med = torch.where(a1 & (med == 0.0) & any_c, d_first, med)
        d_sum = torch.where(a1, d_sum + wm.sum(-1), d_sum)
        a_sum = torch.where(a1, a_sum + w.sum(-1), a_sum)
        n_sum = torch.where(a1[..., None], n_sum + torch.einsum(
            "tpc,tkc->tpk", w, geo["n3"]), n_sum)
        T_carry = torch.where(a1, T_carry * torch.exp(logs.sum(-1)),
                              T_carry)
    out = torch.cat([d_sum[..., None], a_sum[..., None], n_sum,
                     med[..., None], dist[..., None], T_carry[..., None]],
                    dim=-1)
    return out, tbound


def raster_fwd(F, lists, counts, rays, pix, *, chunk: int, width: int,
               with_median: bool, with_dist: bool):
    """K1: (out [T, P, 8], tbound [T, P, K/chunk])."""
    if not _on_cuda(F):
        return raster_fwd_plain(F, lists, counts, rays, pix, chunk=chunk,
                                width=width, with_median=with_median,
                                with_dist=with_dist)
    n_tiles, k_cap, p_tile = _check_tiles(F, lists, counts, rays, pix,
                                          chunk)
    out = torch.empty((n_tiles, p_tile, 8), dtype=torch.float32,
                      device=F.device)
    tbound = torch.empty((n_tiles, p_tile, k_cap // chunk),
                         dtype=torch.float32, device=F.device)
    _launch("K1_fwd", F.data_ptr(), lists.data_ptr(), counts.data_ptr(),
            rays.data_ptr(), pix.data_ptr(), out.data_ptr(),
            tbound.data_ptr(), n_tiles, k_cap, chunk, p_tile,
            float(width), 1.0 / width, int(with_median), int(with_dist),
            _stream(F))
    return out, tbound


# ---------------------------------------------------------------------------
# K2: backward
# ---------------------------------------------------------------------------

def _bwd_rows(geo, rays, gN, Ti, w, phi, S_phi, gm):
    """A chunk's gradient rows [T, 16, C] summed over the pixels, from the
    per-pair [T, P, C] T_i, w, phi, strict-suffix sum of w*phi and the
    depth cotangent gm (the TPU kernel's arithmetic)."""
    alpha = geo["alpha"]
    one_m_a = torch.clamp(1.0 - alpha, min=1e-3)
    galpha = torch.where(alpha > 0, Ti * phi - S_phi / one_m_a, 0.0)
    live_px = geo["ok"] & (geo["alpha_raw"] < ALPHA_MAX)
    g_opa = torch.where(live_px, galpha * geo["g_exp"], 0.0)
    g_rho = torch.where(live_px, galpha * (-0.5) * geo["alpha_raw"], 0.0)
    use2 = geo["use2"]
    u3 = ~use2
    g_u = torch.where(u3, g_rho * 2.0 * geo["uu"], 0.0)
    g_v = torch.where(u3, g_rho * 2.0 * geo["vv"], 0.0)
    g_t = g_u * geo["A1"] + g_v * geo["A2"] + torch.where(u3, gm, 0.0)
    g_np = g_t / geo["A3"]
    g_A3 = -g_t * geo["tstar"] / geo["A3"]
    g_A1 = g_u * geo["tstar"]
    g_A2 = g_v * geo["tstar"]
    g_dx = torch.where(use2, g_rho * 2.0 * FILTER_INV_SQUARE * geo["dx"], 0.0)
    g_dy = torch.where(use2, g_rho * 2.0 * FILTER_INV_SQUARE * geo["dy"], 0.0)

    def sum_px(x):                                 # [T, P, C] -> [T, 1, C]
        return x.sum(dim=1, keepdim=True)

    def dot_rays(x):                               # -> [T, 3, C]
        return torch.einsum("tpk,tpc->tkc", rays, x)

    s_g_np, s_g_u, s_g_v = sum_px(g_np), sum_px(g_u), sum_px(g_v)
    d_gu = dot_rays(g_A1) - s_g_u * geo["p3"]
    d_gv = dot_rays(g_A2) - s_g_v * geo["p3"]
    d_n = (dot_rays(g_A3) + s_g_np * geo["p3"]
           + torch.einsum("tpk,tpc->tkc", gN, w))
    d_p = s_g_np * geo["n3"] - s_g_u * geo["gu3"] - s_g_v * geo["gv3"]
    return torch.cat([d_p, d_gu, d_gv, d_n, sum_px(g_opa),
                      sum_px(torch.where(use2, gm, 0.0)),
                      sum_px(-g_dx), sum_px(-g_dy)], dim=1)


def _live_chunks(counts, tbound, chunk):
    """[T] number of chunks the forward composited: within the count and
    chunk-start T > T_EPS for some pixel (a prefix of the chunks)."""
    n_chunks = tbound.shape[2]
    col = torch.arange(n_chunks, device=tbound.device)
    live = ((col[None, :] < _n_active_chunks(counts, chunk)[:, None])
            & (tbound.amax(dim=1) > T_EPS))
    return live.sum(dim=1)


def raster_bwd_plain(F, lists, counts, rays, pix, tbound, outs, g, *,
                     chunk: int, width: int, with_dist: bool):
    """Plain version of K2: reverse loop over each tile's live chunks
    (those the forward ran: chunk-start T > T_EPS for some pixel), with
    O(P) suffix carries; closed-form in-chunk prefix/suffix sums."""
    n_tiles, k_cap = lists.shape
    n_chunks = k_cap // chunk
    n_live = _live_chunks(counts, tbound, chunk)               # [T]
    gD, gA, gN, gdist = g[..., 0:1], g[..., 1:2], g[..., 2:5], g[..., 6:7]
    A_total, D_total = outs[..., 1:2], outs[..., 0:1]
    S_phi_c = torch.zeros_like(gD)
    W_c = torch.zeros_like(gD)
    MD_c = torch.zeros_like(gD)
    dFg = F.new_zeros((n_tiles, k_cap, 16))
    for i in range(n_chunks - 1, -1, -1):
        a1 = (i < n_live)[:, None, None]                       # [T, 1, 1]
        if not bool(a1.any()):
            continue
        T_start = tbound[:, :, i:i + 1]
        Fc = F[lists[:, i * chunk:(i + 1) * chunk].long()]
        geo = _splat_geometry(Fc, rays, pix, width)
        alpha, m = geo["alpha"], geo["m"]
        Ti = T_start * torch.exp(_excl_cumsum(torch.log1p(-alpha)))
        w = alpha * Ti
        wm = w * m
        n3 = geo["n3"]                                         # [T, 3, C]
        nphi = torch.einsum("tpk,tkc->tpc", gN, n3)
        phi = gD * m + gA + nphi
        if with_dist:
            W_suf = _strict_suffix_sum(w) + W_c
            MD_suf = _strict_suffix_sum(wm) + MD_c
            A_prev = A_total - w - W_suf
            D_prev = D_total - wm - MD_suf
            phi = phi + gdist * (m * A_prev - D_prev + MD_suf - m * W_suf)
        S_phi = _strict_suffix_sum(w * phi) + S_phi_c
        gm = w * gD
        if with_dist:
            gm = gm + w * gdist * (A_prev - W_suf)
        dF = _bwd_rows(geo, rays, gN, Ti, w, phi, S_phi, gm)
        dFg[:, i * chunk:(i + 1) * chunk] = torch.where(
            a1, dF.transpose(1, 2), 0.0)
        S_phi_c = torch.where(a1, S_phi_c + torch.sum(w * phi, -1, True),
                              S_phi_c)
        W_c = torch.where(a1, W_c + torch.sum(w, -1, True), W_c)
        MD_c = torch.where(a1, MD_c + torch.sum(wm, -1, True), MD_c)
    return dFg


def _launch_bwd(name, dst, F, lists, counts, rays, pix, tbound, outs, g,
                chunk: int, width: int, with_dist: bool):
    """Check K2's / K5's inputs and launch ``name`` writing into ``dst``."""
    n_tiles, k_cap, p_tile = _check_tiles(F, lists, counts, rays, pix,
                                          chunk)
    dev = F.device
    _check("tbound", tbound, torch.float32,
           (n_tiles, p_tile, k_cap // chunk), dev)
    _check("outs", outs, torch.float32, (n_tiles, p_tile, 8), dev)
    _check("g", g, torch.float32, (n_tiles, p_tile, 8), dev)
    _launch(name, F.data_ptr(), lists.data_ptr(), counts.data_ptr(),
            rays.data_ptr(), pix.data_ptr(), tbound.data_ptr(),
            outs.data_ptr(), g.data_ptr(), dst.data_ptr(), n_tiles, k_cap,
            chunk, p_tile, float(width), 1.0 / width, int(with_dist),
            _stream(F))
    return dst


def raster_bwd(F, lists, counts, rays, pix, tbound, outs, g, *,
               chunk: int, width: int, with_dist: bool):
    """K2: dFg [T, K, 16] per-slot feature gradients (the median channel
    is not differentiated).  Rows past each tile's count are zeros in the
    plain version and left unwritten by the kernel: no reduction reads
    them."""
    if not _on_cuda(F):
        return raster_bwd_plain(F, lists, counts, rays, pix, tbound, outs,
                                g, chunk=chunk, width=width,
                                with_dist=with_dist)
    dFg = torch.empty((*lists.shape, 16), dtype=torch.float32,
                      device=F.device)
    return _launch_bwd("K2_bwd", dFg, F, lists, counts, rays, pix, tbound,
                       outs, g, chunk, width, with_dist)


# ---------------------------------------------------------------------------
# K3: segmented sum of id-sorted rows into rank rows
# ---------------------------------------------------------------------------

def ranksum_rows_plain(rows, pos, ranks, pad_rank, n_rows: int):
    """Plain version of K3: dFc[ranks[e]] += rows[pos[e]] for the entries
    whose rank is >= 0 and not ``pad_rank``."""
    real = (ranks >= 0) & (ranks != pad_rank)
    dFc = rows.new_zeros((n_rows, 16))
    return dFc.index_add_(0, ranks[real].long(), rows[pos[real].long()])


def ranksum_rows(rows, pos, ranks, pad_rank, n_rows: int):
    """K3: rows [R, 16] (any slot layout), pos [E] int32 slot of each
    id-sorted entry, ranks [E] int32 dense ranks, non-decreasing up to a
    tail of -1 pads, pad_rank [1] int32 the padding id's rank
    (``rank_of_id[N:]`` of the plan, read on the device) -> dFc
    [n_rows, 16], row r = sum of the rows whose id has rank r.  The
    padding id's entries contribute nothing: its row, and every row no
    entry has, is 0."""
    if not _on_cuda(rows):
        return ranksum_rows_plain(rows, pos, ranks, pad_rank, n_rows)
    dev = rows.device
    n_entries = pos.shape[0]
    _check("rows", rows, torch.float32, (rows.shape[0], 16), dev)
    _check("pos", pos, torch.int32, (n_entries,), dev)
    _check("ranks", ranks, torch.int32, (n_entries,), dev)
    # one view's rank out of a [B, N+1] stack of plans: read as one int
    _check("pad_rank", pad_rank, torch.int32, (1,), dev, align=4)
    dFc = torch.zeros((n_rows, 16), dtype=torch.float32, device=dev)
    _launch("K3_ranksum", rows.data_ptr(), pos.data_ptr(), ranks.data_ptr(),
            pad_rank.data_ptr(), dFc.data_ptr(), n_entries, _stream(rows))
    return dFc


# ---------------------------------------------------------------------------
# K4: scatter-add of the real slots' rows by surfel id
# ---------------------------------------------------------------------------

def scatter_rows_plain(dFg, lists, counts, n_rows: int):
    """Plain version of K4: dF[lists[t, j]] += dFg[t, j] for j < counts[t]."""
    k_cap = lists.shape[1]
    real = torch.arange(k_cap, device=dFg.device)[None, :] < counts[:, None]
    dF = dFg.new_zeros((n_rows, 16))
    return dF.index_add_(0, lists[real].long(), dFg[real])


def scatter_rows(dFg, lists, counts, n_rows: int):
    """K4: dFg [T, K, 16] -> dF [n_rows, 16] by surfel id."""
    return scatter_rows_tps(dFg, lists, counts, n_rows, 1)


# ---------------------------------------------------------------------------
# K5: backward fused with the scatter-add reduction
# ---------------------------------------------------------------------------

def raster_bwd_fused_plain(F, lists, counts, rays, pix, tbound, outs, g,
                           n_rows: int, *, chunk: int, width: int,
                           with_dist: bool):
    """Plain version of K5: K2's plain rows reduced by K4's plain
    version."""
    dFg = raster_bwd_plain(F, lists, counts, rays, pix, tbound, outs, g,
                           chunk=chunk, width=width, with_dist=with_dist)
    return scatter_rows_plain(dFg, lists, counts, n_rows)


def raster_bwd_fused(F, lists, counts, rays, pix, tbound, outs, g,
                     n_rows: int, *, chunk: int, width: int,
                     with_dist: bool):
    """K5: dF [n_rows, 16] per-surfel feature gradients, K2's rows added
    into the pool by surfel id inside the kernel (dFg is never stored)."""
    if not _on_cuda(F):
        return raster_bwd_fused_plain(F, lists, counts, rays, pix, tbound,
                                      outs, g, n_rows, chunk=chunk,
                                      width=width, with_dist=with_dist)
    dF = torch.zeros((n_rows, 16), dtype=torch.float32, device=F.device)
    return _launch_bwd("K5_bwd_fused", dF, F, lists, counts, rays, pix,
                       tbound, outs, g, chunk, width, with_dist)


# ---------------------------------------------------------------------------
# K6: count-aware scatter-add of overflow rows
# ---------------------------------------------------------------------------

def scatter_overflow_plain(rows, slots, ids, n_ov, n_rows: int):
    """Plain version of K6: dF[ids[e]] += rows[slots[e]] for e < n_ov."""
    n = int(n_ov)
    dF = rows.new_zeros((n_rows, 16))
    return dF.index_add_(0, ids[:n].long(), rows[slots[:n].long()])


def scatter_overflow(rows, slots, ids, n_ov, n_rows: int):
    """K6: rows [R, 16] per-slot rows, slots [C] int32 the slot of each
    overflow entry, ids [C] int32 its surfel id, n_ov [] int32 live entry
    count (a device scalar, read by the kernel, never by the host) -> dF
    [n_rows, 16].  The kernel gathers each entry's row itself and sums
    runs of equal ids (the plans sort their entries by id) before its
    atomics."""
    if not _on_cuda(rows):
        return scatter_overflow_plain(rows, slots, ids, n_ov, n_rows)
    dev = rows.device
    n_entries = ids.shape[0]
    _check("rows", rows, torch.float32, (rows.shape[0], 16), dev)
    _check("slots", slots, torch.int32, (n_entries,), dev, align=4)
    _check("ids", ids, torch.int32, (n_entries,), dev, align=4)
    # one view's count out of a [B] stack of plans: read as one int
    _check("n_ov", n_ov, torch.int32, (), dev, align=4)
    dF = torch.zeros((n_rows, 16), dtype=torch.float32, device=dev)
    _launch("K6_scatter_overflow", rows.data_ptr(), slots.data_ptr(),
            ids.data_ptr(), n_ov.data_ptr(), dF.data_ptr(), n_entries,
            _stream(rows))
    return dF


# ---------------------------------------------------------------------------
# K4 at scatter_tps > 1: K10
# ---------------------------------------------------------------------------

def scatter_rows_tps(dFg, lists, counts, n_rows: int, tps: int):
    """K4's sums under RenderParams.scatter_tps (tps must divide T), dFg
    [T, K, 16] -> dF [n_rows, 16]: one kernel launch, counted as K4 at
    tps 1 and as K10 above (the TPU's tiles per grid step have no
    counterpart on the card).  Its plain version is K4's."""
    n_tiles, k_cap = lists.shape
    if tps < 1 or n_tiles % tps:
        raise ValueError(f"tps {tps} must divide the tile count {n_tiles}")
    if not _on_cuda(dFg):
        return scatter_rows_plain(dFg, lists, counts, n_rows)
    dev = dFg.device
    _check("dFg", dFg, torch.float32, (n_tiles, k_cap, 16), dev)
    _check("lists", lists, torch.int32, (n_tiles, k_cap), dev)
    _check("counts", counts, torch.int32, (n_tiles,), dev)
    dF = torch.zeros((n_rows, 16), dtype=torch.float32, device=dev)
    _launch("K4_scatter_rows" if tps == 1 else "K10_scatter_rows_tps",
            dFg.data_ptr(), lists.data_ptr(), counts.data_ptr(),
            dF.data_ptr(), n_tiles, k_cap, _stream(dFg))
    return dF


# ---------------------------------------------------------------------------
# K7, K8: forward and backward over the flat slot pool
# ---------------------------------------------------------------------------

def _flat_as_tiles(ids, starts, chunk: int):
    """The flat layout as padded per-tile lists, for the plain versions:
    (lists [B*T, M*chunk], counts [B*T] int32, chunk_of [B*T, M] the flat
    chunk of each tile's i-th chunk, owned [B*T, M] bool), M = the most
    chunks any tile owns.  Every owned slot is composited, pads included,
    as the kernels do."""
    b = starts.shape[0]
    dev = ids.device
    st = starts.long()
    ncv = ids.shape[0] // b // chunk
    lo = (st[:, :-1] // chunk
          + torch.arange(b, device=dev)[:, None] * ncv).reshape(-1)
    n = ((st[:, 1:] - st[:, :-1]) // chunk).reshape(-1)
    m = int(n.max()) if n.numel() else 0
    i = torch.arange(m, device=dev)
    owned = i[None, :] < n[:, None]
    chunk_of = lo[:, None] + i[None, :]
    slots = chunk_of[..., None] * chunk + torch.arange(chunk, device=dev)
    lists = ids[torch.clamp(slots, max=ids.shape[0] - 1)]
    return (lists.reshape(n.shape[0], m * chunk),
            (n * chunk).to(torch.int32), chunk_of, owned)


def raster_fwd_flat_plain(F, ids, starts, rays, pix, *, chunk: int,
                          width: int, with_median: bool, with_dist: bool):
    """Plain version of K7: K1's plain version over each tile's chunk
    range, with tbound moved to the flat chunks (0 for chunks no tile
    owns)."""
    lists, counts, chunk_of, owned = _flat_as_tiles(ids, starts, chunk)
    out, tb = raster_fwd_plain(F, lists, counts, rays, pix, chunk=chunk,
                               width=width, with_median=with_median,
                               with_dist=with_dist)
    tbound = rays.new_zeros((ids.shape[0] // chunk, rays.shape[1]))
    tbound[chunk_of[owned]] = tb.transpose(1, 2)[owned]
    return out, tbound


def _check_flat(F, ids, starts, rays, pix, chunk):
    n_views, tp1 = starts.shape
    n_tiles, p_tile = rays.shape[:2]
    n_slots = ids.shape[0]
    dev = F.device
    _check("F", F, torch.float32, (F.shape[0], 16), dev)
    _check("ids", ids, torch.int32, (n_slots,), dev)
    _check("starts", starts, torch.int32, (n_views, tp1), dev)
    _check("rays", rays, torch.float32, (n_views * (tp1 - 1), p_tile, 3),
           dev)
    _check("pix", pix, torch.float32, (n_tiles, p_tile, 2), dev)
    if p_tile % 32 or p_tile > MAX_TILE_PIXELS:
        raise ValueError(f"tile of {p_tile} pixels: the kernels take a "
                         f"multiple of 32 up to {MAX_TILE_PIXELS}")
    if chunk % SUB or chunk > MAX_CHUNK or n_slots % (n_views * chunk):
        raise ValueError(f"chunk {chunk} must be a multiple of {SUB} up "
                         f"to {MAX_CHUNK} dividing each view's slots")
    return n_tiles, p_tile, n_slots // n_views, tp1 - 1


def raster_fwd_flat(F, ids, starts, rays, pix, *, chunk: int, width: int,
                    with_median: bool, with_dist: bool):
    """K7: (out [B*T, P, 8], tbound [B*E/chunk, P]); a tile that owns no
    chunk comes out as the empty state (zeros, final T = 1)."""
    if not _on_cuda(F):
        return raster_fwd_flat_plain(F, ids, starts, rays, pix, chunk=chunk,
                                     width=width, with_median=with_median,
                                     with_dist=with_dist)
    n_tiles, p_tile, e_view, t_view = _check_flat(F, ids, starts, rays, pix,
                                                  chunk)
    out = torch.empty((n_tiles, p_tile, 8), dtype=torch.float32,
                      device=F.device)
    # the kernel zeroes the chunks no tile reached, owned or not
    tbound = torch.empty((ids.shape[0] // chunk, p_tile),
                         dtype=torch.float32, device=F.device)
    _launch("K7_fwd_flat", F.data_ptr(), ids.data_ptr(), starts.data_ptr(),
            rays.data_ptr(), pix.data_ptr(), out.data_ptr(),
            tbound.data_ptr(), n_tiles, e_view, t_view, chunk, p_tile,
            float(width), 1.0 / width, int(with_median), int(with_dist),
            _stream(F))
    return out, tbound


def raster_bwd_flat_plain(F, ids, starts, rays, pix, tbound, outs, g, *,
                          chunk: int, width: int, with_dist: bool):
    """Plain version of K8: K2's plain version over each tile's chunk
    range, its rows moved to the flat slots (0 for chunks no tile owns)."""
    lists, counts, chunk_of, owned = _flat_as_tiles(ids, starts, chunk)
    n_tiles, m = owned.shape
    tb = tbound.new_zeros((n_tiles, m, tbound.shape[1]))
    tb[owned] = tbound[chunk_of[owned]]
    dFg = raster_bwd_plain(F, lists, counts, rays, pix, tb.transpose(1, 2),
                           outs, g, chunk=chunk, width=width,
                           with_dist=with_dist)
    rows = F.new_zeros((ids.shape[0] // chunk, chunk, 16))
    rows[chunk_of[owned]] = dFg.reshape(n_tiles, m, chunk, 16)[owned]
    return rows.reshape(-1, 16)


def _launch_bwd_flat(rows, F, ids, starts, rays, pix, tbound, outs, g,
                     chunk: int, width: int, with_dist: bool):
    """Check K8's inputs and launch it writing into ``rows``."""
    n_tiles, p_tile, e_view, t_view = _check_flat(F, ids, starts, rays, pix,
                                                  chunk)
    dev = F.device
    _check("tbound", tbound, torch.float32,
           (ids.shape[0] // chunk, p_tile), dev)
    _check("outs", outs, torch.float32, (n_tiles, p_tile, 8), dev)
    _check("g", g, torch.float32, (n_tiles, p_tile, 8), dev)
    _check("rows", rows, torch.float32, (ids.shape[0], 16), dev)
    _launch("K8_bwd_flat", F.data_ptr(), ids.data_ptr(), starts.data_ptr(),
            rays.data_ptr(), pix.data_ptr(), tbound.data_ptr(),
            outs.data_ptr(), g.data_ptr(), rows.data_ptr(), n_tiles, e_view,
            t_view, chunk, p_tile, float(width), 1.0 / width, int(with_dist),
            _stream(F))
    return rows


def raster_bwd_flat(F, ids, starts, rays, pix, tbound, outs, g, *,
                    chunk: int, width: int, with_dist: bool):
    """K8: rows [B*E, 16] per flat slot (the median channel is not
    differentiated); rows of chunks the forward skipped and of pads are 0.
    The rows of chunks no tile owns are 0 in the plain version and left
    unwritten by the kernel: K9 does not read them."""
    if not _on_cuda(F):
        return raster_bwd_flat_plain(F, ids, starts, rays, pix, tbound,
                                     outs, g, chunk=chunk, width=width,
                                     with_dist=with_dist)
    rows = torch.empty((ids.shape[0], 16), dtype=torch.float32,
                       device=F.device)
    return _launch_bwd_flat(rows, F, ids, starts, rays, pix, tbound, outs, g,
                            chunk, width, with_dist)


# ---------------------------------------------------------------------------
# K9: scatter-add of the owned, non-pad flat slots' rows
# ---------------------------------------------------------------------------

def _flat_summed_slots(ids, starts, n_rows: int):
    """[B*E] bool: the flat slots K9 sums, those some tile owns (slot j of
    view v with j < starts[v, T]) whose id is not the view's dummy row
    (v + 1) * n_rows / B - 1."""
    n_views = starts.shape[0]
    e_view, r_view = ids.shape[0] // n_views, n_rows // n_views
    j = torch.arange(e_view, device=ids.device)
    owned = j[None, :] < starts[:, -1:].long()
    pad = (torch.arange(1, n_views + 1, device=ids.device)[:, None] * r_view
           - 1)
    return (owned & (ids.reshape(n_views, e_view).long() != pad)).reshape(-1)


def scatter_rows_flat_plain(rows, ids, starts, n_rows: int):
    """Plain version of K9: dF[ids[j]] += rows[j] for the slots of
    ``_flat_summed_slots``; no other row is read."""
    keep = _flat_summed_slots(ids, starts, n_rows)
    return rows.new_zeros((n_rows, 16)).index_add_(0, ids[keep].long(),
                                                   rows[keep])


def scatter_rows_flat(rows, ids, starts, n_rows: int):
    """K9: rows [B*E, 16], ids [B*E] int32, starts [B, T+1] int32 -> dF
    [n_rows, 16] (B views of n_rows / B rows each): the rows of the slots
    some tile owns, pads (each view's dummy row) excepted, summed by id."""
    if not _on_cuda(rows):
        return scatter_rows_flat_plain(rows, ids, starts, n_rows)
    dev = rows.device
    n_slots = ids.shape[0]
    n_views, tp1 = starts.shape
    _check("rows", rows, torch.float32, (n_slots, 16), dev)
    _check("ids", ids, torch.int32, (n_slots,), dev)
    _check("starts", starts, torch.int32, (n_views, tp1), dev)
    if n_slots % n_views or n_rows % n_views:
        raise ValueError(f"{n_slots} slots and {n_rows} rows must split "
                         f"evenly over {n_views} views")
    dF = torch.zeros((n_rows, 16), dtype=torch.float32, device=dev)
    _launch("K9_scatter_rows_flat", rows.data_ptr(), ids.data_ptr(),
            starts.data_ptr(), dF.data_ptr(), n_views, n_slots // n_views,
            tp1 - 1, n_rows // n_views, _stream(rows))
    return dF
