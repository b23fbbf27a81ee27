"""TSDF fusion + isosurface extraction (marching tetrahedra), self-contained.

The port's copy of splatloam_tpu/eval/tsdf.py.  ``fuse_points_tsdf`` fuses
the rendered keyframe clouds into a signed-distance voxel grid with torch
``index_add_`` on the run's device (the JAX package's jnp scatter-adds; a
plain array function there, with no Pallas kernel of its own); the zero
isosurface is triangulated with marching *tetrahedra* (each cube split
into 6 tets, table-free, watertight per tet, vectorized in numpy), and
``poisson_grid`` and ``save_mesh_ply`` are numpy, copied as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..logging_utils import get_logger

logger = get_logger("tsdf")

MAX_VOXELS = 320 ** 3  # safety bound for the dense grid


def fuse_points_tsdf(points: np.ndarray, normals: np.ndarray,
                     voxel_size: float, trunc: float, device=None):
    """Fuse an oriented point cloud into a dense TSDF grid.

    Each point contributes signed distances  d = n . (v - p)  to the voxels
    within the truncation band along its normal (point-to-plane TSDF).
    The sums run in float32 on ``device`` (default cuda; raises without a
    GPU), 32 band offsets at a time.
    Returns (tsdf [X,Y,Z] with NaN = unobserved, origin [3]).
    """
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    nn = np.linalg.norm(normals, axis=1, keepdims=True)
    ok = (nn[:, 0] > 1e-6) & np.isfinite(points).all(axis=1)
    points, normals = points[ok], normals[ok] / nn[ok]

    lo = points.min(axis=0) - trunc - voxel_size
    hi = points.max(axis=0) + trunc + voxel_size
    dims = np.ceil((hi - lo) / voxel_size).astype(int) + 1
    if int(np.prod(dims)) > MAX_VOXELS:
        raise ValueError(f"TSDF grid {dims} exceeds {MAX_VOXELS} voxels; "
                         "increase voxel_size")
    logger.info(f"TSDF grid {tuple(dims)} @ {voxel_size} m, "
                f"{len(points)} points")
    dev = resolve_device(device)

    # offsets within the truncation band (cube of radius r voxels)
    r = max(int(np.ceil(trunc / voxel_size)), 1)
    offs = np.stack(np.meshgrid(*[np.arange(-r, r + 1)] * 3,
                                indexing="ij"), -1).reshape(-1, 3)

    base = np.round((points - lo) / voxel_size).astype(np.int32)  # [N,3]
    nvox = int(np.prod(dims))
    tsdf_num = torch.zeros((nvox,), dtype=torch.float32, device=dev)
    tsdf_den = torch.zeros((nvox,), dtype=torch.float32, device=dev)
    pts_t = torch.tensor(points, device=dev)
    nrm_t = torch.tensor(normals, device=dev)
    base_t = torch.tensor(base, device=dev)
    lo_t = torch.tensor(lo, device=dev)
    dims_t = torch.tensor(dims, dtype=torch.int32, device=dev)

    # chunk over offsets to bound memory: each pass scatters N values
    for chunk_start in range(0, len(offs), 32):
        chunk = torch.tensor(offs[chunk_start:chunk_start + 32],
                             dtype=torch.int32, device=dev)
        for k in range(chunk.shape[0]):
            vox = base_t + chunk[k][None, :]
            vpos = lo_t + vox.float() * voxel_size
            d = torch.sum(nrm_t * (vpos - pts_t), dim=-1)
            # weight: full inside band, fading to 0 at truncation
            w = torch.clamp(1.0 - torch.abs(d) / trunc, 0.0, 1.0)
            inb = ((vox >= 0).all(dim=-1)
                   & (vox < dims_t[None, :]).all(dim=-1))
            w = torch.where(inb, w, 0.0)
            flat = (vox[:, 0] * int(dims[1]) + vox[:, 1]) * int(dims[2]) \
                + vox[:, 2]
            flat = torch.clamp(flat, 0, nvox - 1).long()
            d = torch.clamp(d, -trunc, trunc)
            tsdf_num.index_add_(0, flat, w * d)
            tsdf_den.index_add_(0, flat, w)

    num = tsdf_num.cpu().numpy().reshape(dims)
    den = tsdf_den.cpu().numpy().reshape(dims)
    tsdf = np.where(den > 1e-6, num / np.maximum(den, 1e-6), np.nan)
    return tsdf.astype(np.float32), lo.astype(np.float64)


# tetrahedral decomposition of a cube (6 tets, consistent orientation)
_CUBE_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                          [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])


def marching_cubes(tsdf: np.ndarray, origin: np.ndarray,
                   voxel_size: float):
    """Zero-isosurface via marching tetrahedra; NaN cells are skipped.

    Returns (vertices [V, 3] float64, triangles [T, 3] int32), vertices
    deduplicated on shared tet edges.
    """
    dims = np.array(tsdf.shape)
    # cells whose 8 corners are all observed
    obs = ~np.isnan(tsdf)
    valid_cell = np.ones(dims - 1, bool)
    vals8 = []
    for corner in _CUBE_CORNERS:
        sl = tuple(slice(c, c + d - 1) for c, d in zip(corner, dims))
        block = tsdf[sl]
        valid_cell &= obs[sl]
        vals8.append(block)
    vals8 = np.stack(vals8, axis=-1)  # [X-1, Y-1, Z-1, 8]
    cidx = np.argwhere(valid_cell)
    if len(cidx) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    vals = vals8[valid_cell]          # [C, 8]

    # only keep cells straddling the isosurface
    straddle = (vals.min(axis=1) < 0) & (vals.max(axis=1) > 0)
    cidx, vals = cidx[straddle], vals[straddle]
    if len(cidx) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)

    tri_list = []
    for tet in _TETS:
        tv = vals[:, tet]                       # [C, 4]
        inside = tv < 0                         # [C, 4]
        count = inside.sum(axis=1)
        corners = cidx[:, None, :] + _CUBE_CORNERS[tet][None, :, :]  # [C,4,3]

        def edge_vertex(sel, a, b):
            va = tv[sel, a]
            vb = tv[sel, b]
            t = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
            t = np.clip(t, 0.0, 1.0)[:, None]
            pa = corners[sel, a].astype(np.float64)
            pb = corners[sel, b].astype(np.float64)
            return pa + t * (pb - pa)

        # case 1 / 3 inside: one triangle; case 2: a quad (two triangles)
        for flag, single in ((1, True), (3, True)):
            sel = count == flag
            if not sel.any():
                continue
            # the lone corner (inside if flag==1 else outside)
            lone_mask = inside[sel] if flag == 1 else ~inside[sel]
            lone = np.argmax(lone_mask, axis=1)
            others = np.array([[b for b in range(4) if b != a]
                               for a in range(4)])
            o = others[lone]                      # [S, 3]
            s_idx = np.nonzero(sel)[0]
            v0 = edge_vertex(s_idx, lone, o[:, 0])
            v1 = edge_vertex(s_idx, lone, o[:, 1])
            v2 = edge_vertex(s_idx, lone, o[:, 2])
            tri_list.append(np.stack([v0, v1, v2], axis=1))
        sel = count == 2
        if sel.any():
            s_idx = np.nonzero(sel)[0]
            ins = inside[sel]
            # inside pair (a0, a1), outside pair (b0, b1)
            a0 = np.argmax(ins, axis=1)
            a1 = 3 - np.argmax(ins[:, ::-1], axis=1)
            outs = ~ins
            b0 = np.argmax(outs, axis=1)
            b1 = 3 - np.argmax(outs[:, ::-1], axis=1)
            e00 = edge_vertex(s_idx, a0, b0)
            e01 = edge_vertex(s_idx, a0, b1)
            e10 = edge_vertex(s_idx, a1, b0)
            e11 = edge_vertex(s_idx, a1, b1)
            tri_list.append(np.stack([e00, e01, e11], axis=1))
            tri_list.append(np.stack([e00, e11, e10], axis=1))

    if not tri_list:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    tris = np.concatenate(tri_list)               # [T, 3, 3] in voxel coords
    flat = tris.reshape(-1, 3)
    # dedup vertices (quantized to 1e-5 voxel)
    keys = np.round(flat * 1e5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3))
    verts[inv] = flat
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]
    verts_world = verts * voxel_size + np.asarray(origin)[None, :]
    logger.info(f"marching tetrahedra: {len(verts_world)} vertices, "
                f"{len(faces)} faces")
    return verts_world, faces


def poisson_grid(points: np.ndarray, normals: np.ndarray,
                 voxel_size: float, pad_voxels: int = 8,
                 density_quantile: float = 0.01,
                 smooth_voxels: float = 1.0,
                 screen_voxels: float = 0.0):
    """Self-contained Poisson surface reconstruction on a regular grid.

    Replaces Open3D's octree screened-Poisson (ref
    scene/postprocessing.py:199-215) when Open3D is unavailable: the
    oriented samples are trilinearly splatted into a vector field V, the
    indicator is recovered by an FFT solve of the (periodic, padded)
    Poisson equation lap(chi) = div V with a Gaussian low-pass, the
    iso-level is the sample-mean of chi (Kazhdan et al.'s rule), and —
    like the reference's density-quantile vertex trimming — the field is
    masked to NaN away from observed samples so the open-scan Poisson
    hallucinations never reach the triangulation (marching tetrahedra
    skip NaN cells).  Returns (vertices [V,3], triangles [T,3]).

    ``screen_voxels`` > 0 solves the SCREENED Poisson equation
    lap(chi) - alpha*chi = div V with alpha = 1/(screen_voxels*h)^2 —
    the grid analog of Open3D/Kazhdan's screening term: chi decays to 0
    within ~screen_voxels cells of the data, tightening the fit and
    suppressing the unscreened solve's long-range bleed through thin
    walls (measured 3-way mesher table: PARITY.md round 5).
    """
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    nn = np.linalg.norm(normals, axis=1, keepdims=True)
    ok = (nn[:, 0] > 1e-6) & np.isfinite(points).all(axis=1)
    points, normals = points[ok], normals[ok] / nn[ok]
    if len(points) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)

    lo = points.min(axis=0) - pad_voxels * voxel_size
    hi = points.max(axis=0) + pad_voxels * voxel_size
    dims = np.ceil((hi - lo) / voxel_size).astype(int) + 1
    if int(np.prod(dims)) > MAX_VOXELS:
        raise ValueError(f"Poisson grid {dims} exceeds {MAX_VOXELS} "
                         "voxels; increase voxel_size")
    logger.info(f"Poisson grid {tuple(dims)} @ {voxel_size} m, "
                f"{len(points)} samples")

    # trilinear splat of normals into V and of counts into the density
    g = (points - lo) / voxel_size
    g0 = np.floor(g).astype(np.int64)
    frac = g - g0
    V = np.zeros((*dims, 3), np.float32)
    dens = np.zeros(dims, np.float32)
    for corner in _CUBE_CORNERS:
        w = np.prod(np.where(corner[None, :] == 1, frac, 1.0 - frac),
                    axis=1).astype(np.float32)
        vox = np.clip(g0 + corner[None, :], 0, dims - 1)
        flat = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
        np.add.at(dens.reshape(-1), flat, w)
        for k in range(3):
            np.add.at(V[..., k].reshape(-1), flat, w * normals[:, k])

    # div V (central differences) -> FFT Poisson solve with low-pass
    h = voxel_size
    rhs = np.zeros(dims, np.float32)
    for k in range(3):
        rhs += np.gradient(V[..., k], h, axis=k).astype(np.float32)
    freqs = [np.fft.fftfreq(d, d=1.0) for d in dims[:2]]
    freqs.append(np.fft.rfftfreq(dims[2], d=1.0))
    # eigenvalues of the 2nd-order central-difference Laplacian
    lam = sum((2.0 * np.cos(2 * np.pi * f) - 2.0).reshape(
        [-1 if i == ax else 1 for i in range(3)])
        for ax, f in enumerate(freqs)) / (h * h)
    lam[(0,) * 3] = 1.0
    rhs_hat = np.fft.rfftn(rhs)
    if smooth_voxels > 0:
        k2 = sum((2 * np.pi * f).reshape(
            [-1 if i == ax else 1 for i in range(3)]) ** 2
            for ax, f in enumerate(freqs))
        rhs_hat *= np.exp(-0.5 * smooth_voxels ** 2 * k2)
    if screen_voxels and screen_voxels > 0:
        # lam <= 0 everywhere, so (lam - alpha) is strictly negative:
        # the screened system is nonsingular including the DC mode
        alpha = 1.0 / (screen_voxels * h) ** 2
        lam = lam.astype(np.float64) - alpha
        lam[(0,) * 3] = -alpha
    chi_hat = rhs_hat / lam
    if not (screen_voxels and screen_voxels > 0):
        chi_hat[(0,) * 3] = 0.0
    chi = np.fft.irfftn(chi_hat, s=tuple(dims),
                        axes=(0, 1, 2)).astype(np.float32)

    # iso-level: mean of chi at the samples (trilinear)
    iso_num = 0.0
    for corner in _CUBE_CORNERS:
        w = np.prod(np.where(corner[None, :] == 1, frac, 1.0 - frac),
                    axis=1)
        vox = np.clip(g0 + corner[None, :], 0, dims - 1)
        iso_num += np.sum(w * chi[vox[:, 0], vox[:, 1], vox[:, 2]])
    iso = iso_num / len(points)
    field = chi - np.float32(iso)

    # density trimming: dilate the sample-density support a few voxels
    # and NaN-mask the field outside it
    try:
        from scipy import ndimage
        support = ndimage.maximum_filter(dens, size=2 * pad_voxels // 2 + 1)
    except Exception:  # scipy-free fallback: axis-wise max dilation
        support = dens
        r = pad_voxels // 2
        for ax in range(3):
            stack = [np.roll(support, s, axis=ax)
                     for s in range(-r, r + 1)]
            support = np.maximum.reduce(stack)
    thr = 0.0
    if density_quantile and density_quantile > 0:
        pos = dens[dens > 0]
        if len(pos):
            thr = float(np.quantile(pos, density_quantile))
    field = np.where(support > thr, field, np.nan).astype(np.float32)
    return marching_cubes(field, lo.astype(np.float64), voxel_size)


def save_mesh_ply(filename, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a triangle mesh PLY (binary little endian)."""
    from pathlib import Path
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(verts)}",
              "property float x", "property float y", "property float z",
              f"element face {len(faces)}",
              "property list uchar int vertex_indices", "end_header"]
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.asarray(verts, "<f4").tobytes())
        body = np.empty((len(faces),),
                        dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        body["n"] = 3
        body["idx"] = faces
        f.write(body.tobytes())
