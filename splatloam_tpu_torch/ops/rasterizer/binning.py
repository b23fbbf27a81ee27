"""Tile binning for the tiled rasterizer (non-differentiable torch ops).

Counterpart of splatloam_tpu/ops/rasterizer/binning.py, tiled and
bucketed layouts: per-tile depth-ordered surfel lists of fixed capacity
(overflow drops the farthest splats), per-tile counts, the two-capacity
tile buckets, the rebin-time plans of the gradient reduction (ranksum,
optionally truncated, and the occurrence tables), and the pixel <-> tile
layout helpers.  Integer
outputs equal the JAX package's exactly: every sort is stable, as
``jnp.argsort`` is, and top-k ties resolve to the lower index, as
``lax.top_k`` does.
"""
from __future__ import annotations

import functools

import torch

from . import common

INT32_MAX = 2 ** 31 - 1


def _argsort(x: torch.Tensor, descending: bool = False) -> torch.Tensor:
    return torch.sort(x, stable=True, descending=descending).indices


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lower index."""
    return _argsort(x, descending=True)[:k]


def _depth_order(packed: common.PackedSurfels):
    sort_key = torch.where(packed.radius_px > 0, packed.depth,
                           float("inf"))
    order = _argsort(sort_key)
    return (order, packed.center_xy[order, 0], packed.center_xy[order, 1],
            packed.extent_px[order, 0], packed.extent_px[order, 1],
            packed.radius_px[order] > 0)


def build_tile_lists(packed: common.PackedSurfels, height: int, width: int,
                     tile_h: int, tile_w: int, capacity: int):
    """Exact binner (unbounded coverage; the parity tests' oracle).

    Returns (lists [T, K] int32 indices into F (N = padding row),
    counts [T] int32, order [N] the depth sort permutation).
    """
    n = packed.depth.shape[0]
    ty, tx = height // tile_h, width // tile_w
    n_tiles = ty * tx
    dev = packed.depth.device
    order, cx, cy, rx, ry, alive = _depth_order(packed)

    # tile centers in continuous pixel coordinates (pixel u center = u-0.5)
    tile_cx = torch.arange(tx, device=dev) * tile_w + tile_w / 2.0 - 0.5
    tile_cy = torch.arange(ty, device=dev) * tile_h + tile_h / 2.0 - 0.5

    dx = cx[None, :] - tile_cx[:, None]
    dx = dx - torch.round(dx / width) * width         # azimuth wrap
    ox = torch.abs(dx) <= (rx[None, :] + tile_w / 2.0)  # [tx, N]
    dy = cy[None, :] - tile_cy[:, None]
    oy = torch.abs(dy) <= (ry[None, :] + tile_h / 2.0)  # [ty, N]
    mask = (oy[:, None, :] & ox[None, :, :]
            & alive[None, None, :]).reshape(n_tiles, n)

    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1   # [T, N]
    counts = torch.clamp(pos[:, -1] + 1, max=capacity).to(torch.int32)
    write = mask & (pos < capacity)
    lists = torch.full((n_tiles, capacity + 1), n, dtype=torch.int64,
                       device=dev)
    tile_idx = torch.arange(n_tiles, device=dev)[:, None].expand(-1, n)
    src = order[None, :].expand(n_tiles, -1)
    lists[tile_idx[write], pos[write]] = src[write]
    return lists[:, :capacity].to(torch.int32), counts, order


def build_tile_lists_sorted(packed: common.PackedSurfels, height: int,
                            width: int, tile_h: int, tile_w: int,
                            capacity: int, cap_ty: int = 9,
                            cap_tx: int = 9, two_tier: bool = True):
    """Sort-based tile lists: tiered capped window emission and ONE global
    sort of (tile_id, depth_rank) keys, then segment starts by
    searchsorted (see the JAX counterpart for the tier guarantees).

    Returns (lists [T, K] int32, counts [T] int32, None).
    """
    sorted_keys, sorted_ids = _emit_sorted_keys(
        packed, height, width, tile_h, tile_w, cap_ty, cap_tx, two_tier)
    n = packed.depth.shape[0]
    n_tiles = (height // tile_h) * (width // tile_w)
    dev = sorted_keys.device
    starts = torch.searchsorted(
        sorted_keys, torch.arange(n_tiles + 1, device=dev) * (n + 1))
    counts = torch.clamp(starts[1:] - starts[:-1], max=capacity)
    slot = torch.arange(capacity, device=dev)[None, :]
    gidx = starts[:-1, None] + slot
    valid = slot < counts[:, None]
    ids_at = sorted_ids[torch.clamp(gidx, max=sorted_keys.shape[0] - 1)]
    lists = torch.where(valid, ids_at, n)
    return lists.to(torch.int32), counts.to(torch.int32), None


def build_flat_lists(packed: common.PackedSurfels, height: int, width: int,
                     tile_h: int, tile_w: int, capacity: int, chunk: int,
                     flat_capacity: int, cap_ty: int = 9, cap_tx: int = 9):
    """Compacted slot pool of ``layout="flat"``: each tile's depth-ordered
    segment back to back in one flat array, padded only to the next chunk
    multiple, so the kernels touch ~sum(counts) slots instead of T*K.

    Returns (flat_ids [E] int32 into F with N = the zero pad row,
             tile_of_chunk [E/chunk] int32,
             starts [T+1] int32 chunk-aligned segment starts,
             counts [T] int32 real per-tile counts), E = flat_capacity.

    Truncation: per-tile counts are capped at ``capacity`` as in the
    [T, K] layout; when the chunk-padded total exceeds ``flat_capacity``,
    tiles fill greedily in tile order and the tail tiles lose their
    deepest entries.  Budget chunks past starts[T] route to the last tile
    and hold pads only.
    """
    if flat_capacity % chunk:
        raise ValueError("flat_capacity must be a chunk multiple")
    n = packed.depth.shape[0]
    n_tiles = (height // tile_h) * (width // tile_w)
    sorted_keys, sorted_ids = _emit_sorted_keys(
        packed, height, width, tile_h, tile_w, cap_ty, cap_tx)
    dev = sorted_keys.device
    bounds = torch.searchsorted(
        sorted_keys, torch.arange(n_tiles + 1, device=dev) * (n + 1))
    seg_starts = bounds[:-1]
    counts = torch.clamp(bounds[1:] - seg_starts, max=capacity)

    pad_t = (counts + chunk - 1) // chunk * chunk
    start_t = torch.cat([pad_t.new_zeros(1), torch.cumsum(pad_t, 0)])
    room_t = torch.minimum(torch.clamp(flat_capacity - start_t[:-1], min=0),
                           pad_t)
    counts2 = torch.minimum(counts, room_t)
    start_clip = torch.clamp(start_t, max=flat_capacity)

    pos = torch.arange(flat_capacity, device=dev)
    tile_of_pos = torch.clamp(
        torch.searchsorted(start_clip[1:], pos, right=True), max=n_tiles - 1)
    j = pos - start_clip[tile_of_pos]
    src = seg_starts[tile_of_pos] + j
    valid = j < counts2[tile_of_pos]
    ids_at = sorted_ids[torch.clamp(src, max=sorted_ids.shape[0] - 1)]
    flat_ids = torch.where(valid, ids_at, n)
    return (flat_ids.to(torch.int32), tile_of_pos[::chunk].to(torch.int32),
            start_clip.to(torch.int32), counts2.to(torch.int32))


@functools.lru_cache(maxsize=None)
def _window_offsets(w_ty: int, w_tx: int, skip_ty: int, skip_tx: int,
                    device: torch.device) -> torch.Tensor:
    """The (dy, dx) tile offsets [n, 2] int64 of a (w_ty x w_tx) window
    minus its inner skip window, on ``device``.  Made once per window and
    device: the host-to-device copy may not run inside a captured CUDA
    graph, which reads the cached tensor at each replay."""
    offs = [(dy, dx)
            for dy in range(-(w_ty // 2), w_ty - w_ty // 2)
            for dx in range(-(w_tx // 2), w_tx - w_tx // 2)
            if not (skip_ty and skip_tx and abs(dy) <= skip_ty // 2
                    and abs(dx) <= skip_tx // 2)]
    return torch.tensor(offs, dtype=torch.int64, device=device)


def _emit_sorted_keys(packed: common.PackedSurfels, height: int,
                      width: int, tile_h: int, tile_w: int,
                      cap_ty: int, cap_tx: int, two_tier: bool = True):
    """Tiered window emission + one global (tile, depth-rank) key sort.
    Returns (sorted_keys [E] int64, sorted_ids [E] int64)."""
    n = packed.depth.shape[0]
    ty, tx = height // tile_h, width // tile_w
    assert ty * tx * (n + 1) < 2 ** 31, "int32 key space exceeded"
    dev = packed.depth.device

    order, cx, cy, rx, ry, alive = _depth_order(packed)
    tcx = torch.floor((cx + 1.0) / tile_w).to(torch.int64)
    tcy = torch.floor((cy + 1.0) / tile_h).to(torch.int64)
    rank = torch.arange(n, device=dev)

    def window_keys(dy, dx, cx, cy, rx, ry, alive, tcx, tcy, rank):
        tyy = tcy + dy
        txx = torch.remainder(tcx + dx, tx)
        ccx = txx.to(torch.float32) * tile_w + tile_w / 2.0 - 0.5
        ccy = tyy.to(torch.float32) * tile_h + tile_h / 2.0 - 0.5
        ddx = cx - ccx
        ddx = ddx - torch.round(ddx / width) * width
        ddy = cy - ccy
        ok = (alive & (tyy >= 0) & (tyy < ty)
              & (torch.abs(ddx) <= rx + tile_w / 2.0)
              & (torch.abs(ddy) <= ry + tile_h / 2.0))
        tile_id = tyy * tx + txx
        return torch.where(ok, tile_id * (n + 1) + rank, INT32_MAX)

    def emit_window(w_ty, w_tx, skip_ty, skip_tx, args, keys, ids):
        """Emit (w_ty x w_tx) window offsets minus the inner skip window,
        all offsets in one broadcast [offsets, surfels] block."""
        cx, cy, rx, ry, alive, tcx, tcy, rank, idv = args
        off = _window_offsets(w_ty, w_tx, skip_ty, skip_tx, dev)
        keys.append(window_keys(off[:, 0:1], off[:, 1:2], cx, cy, rx, ry,
                                alive, tcx, tcy, rank).reshape(-1))
        ids.append(idv.expand(off.shape[0], -1).reshape(-1))

    def gather_args(bidx, needs):
        return (cx[bidx], cy[bidx], rx[bidx], ry[bidx],
                alive[bidx] & needs[bidx], tcx[bidx], tcy[bidx],
                rank[bidx], order[bidx])

    # clamp x-windows to the column count (a wider modular window would
    # visit a column twice); tier 3 is the full image window
    w2_ty, w2_tx = min(cap_ty, 2 * ty - 1), min(cap_tx, tx)
    w3_ty, w3_tx = 2 * ty - 1, tx
    # normalized need (tiles of reach past the center tile)
    score = torch.maximum(rx * (1.0 / tile_w), ry * (1.0 / tile_h))

    keys, ids = [], []
    all_args = (cx, cy, rx, ry, alive, tcx, tcy, rank, order)
    w1_ty, w1_tx = min(3, 2 * ty - 1), min(3, tx)
    if not two_tier:
        emit_window(w3_ty, w3_tx, 0, 0, all_args, keys, ids)
    else:
        emit_window(w1_ty, w1_tx, 0, 0, all_args, keys, ids)
        # tier-3 membership first: its members also hold tier-2
        # membership (tier 3 emits only the annulus beyond w2)
        needs3 = ((rx > (w2_tx // 2) * tile_w)
                  | (ry > (w2_ty // 2) * tile_h))
        k3 = min(n, max(64, n // 256))
        bidx3 = _top_k_indices(torch.where(needs3, score, -1.0), k3)
        member3 = torch.zeros((n,), dtype=torch.bool, device=dev)
        member3[bidx3] = needs3[bidx3]
        if w2_tx > w1_tx or w2_ty > w1_ty:
            needs2 = (rx > tile_w) | (ry > tile_h)
            score2 = torch.where(member3, float("inf"), score)
            bidx2 = _top_k_indices(torch.where(needs2, score2, -1.0),
                                   min(n, max(256, n // 16)))
            emit_window(w2_ty, w2_tx, w1_ty, w1_tx,
                        gather_args(bidx2, needs2), keys, ids)
        if w3_tx > w2_tx or w3_ty > w2_ty:
            emit_window(w3_ty, w3_tx, w2_ty, w2_tx,
                        gather_args(bidx3, needs3), keys, ids)
    all_keys = torch.cat(keys)
    all_ids = torch.cat(ids)
    sorted_keys, perm = torch.sort(all_keys, stable=True)
    return sorted_keys, all_ids[perm]


def build_scatter_plan(lists: torch.Tensor, n_surfels: int, m: int = 4,
                       ov_cap: int = 0):
    """Occurrence tables of the gather-sum gradient reduction
    (``scatter="plan"``).

    One stable argsort of the flat tile lists by surfel id per rebin; for
    each surfel the flat slot positions of its first ``m`` occurrences
    (``occ`` [N+1, m], pad slot T*K), plus a compacted overflow list of
    (slot, id) pairs for the occurrences beyond m (the padding id N
    excluded).  Overflow entries past ``ov_cap`` are dropped, as in the
    JAX package.

    Returns (occ [N+1, m] int32, ov_slots [ov_cap] int32 (pad T*K),
    ov_ids [ov_cap] int32 (pad N), n_ov [] int32).
    """
    tk = lists.numel()
    n = n_surfels
    dev = lists.device
    if ov_cap <= 0:
        ov_cap = max(8, tk // 4)
    ids = lists.reshape(-1).long()
    order = _argsort(ids)
    ids_sorted = ids[order]
    starts = torch.searchsorted(ids_sorted, torch.arange(n + 2, device=dev))
    cnt = starts[1:] - starts[:-1]                       # [N+1]
    j = torch.arange(m, device=dev)
    idx = starts[:-1, None] + j[None, :]
    valid = j[None, :] < torch.clamp(cnt, max=m)[:, None]
    occ = torch.where(valid, order[torch.clamp(idx, 0, tk - 1)], tk)
    # overflow: occurrence rank >= m, excluding the padding id n
    r = torch.arange(tk, device=dev) - starts[:-1][ids_sorted]
    is_ov = (r >= m) & (ids_sorted != n)
    ovpos = torch.cumsum(is_ov.to(torch.int64), dim=0) - 1
    keep = is_ov & (ovpos < ov_cap)          # positions past the cap drop
    ov_slots = torch.full((ov_cap,), tk, dtype=torch.int64, device=dev)
    ov_slots[ovpos[keep]] = order[keep]
    ov_ids = torch.full((ov_cap,), n, dtype=torch.int64, device=dev)
    ov_ids[ovpos[keep]] = ids_sorted[keep]
    n_ov = torch.clamp(is_ov.sum(), max=ov_cap)
    return (occ.to(torch.int32), ov_slots.to(torch.int32),
            ov_ids.to(torch.int32), n_ov.to(torch.int32))


def build_ranksum_plan(lists: torch.Tensor, n_surfels: int,
                       group: int = 128, gps: int = 64,
                       trunc_frac: float = 0.0, ov_cap: int = 0):
    """Rebin-time plan of the segmented-sum gradient reduction.

    One stable argsort of the flat tile lists by surfel id; ranks are
    dense over the distinct ids that appear.  Returns (pos [E] int32 flat
    slot positions in id-sorted order, ranks [E] int32 (pad -1), w_first
    [E/group] int32 first rank of each group, rank_of_id [N+1] int32 with
    absent ids mapped to the never-written dummy row), E = T*K rounded up
    to a multiple of gps*group.  Pad entries point at slot 0 with rank
    -1 and contribute nothing.  ``lists`` may be any flat slot layout.

    Sorted truncation (0 < trunc_frac < 1): the padding id N is the
    largest, so pads form a suffix of the sorted order; the plan keeps the
    first E = max(step, T*K*trunc_frac rounded down to a step multiple)
    entries and returns three more fields, an overflow list of the next
    ``ov_cap`` (default gps*group) sorted entries: ov_slots [<= ov_cap]
    int32 slot positions, ov_ids [<= ov_cap] int32 ids, and n_ov [] int32
    = clip(real entries - E, 0, ov_cap).  Real entries past E + ov_cap
    are dropped, as in the JAX package.
    """
    tk = lists.numel()
    n_plus1 = n_surfels + 1
    dev = lists.device
    ids = lists.reshape(-1).long()
    order = _argsort(ids)
    ids_sorted = ids[order]
    is_new = torch.ones_like(ids_sorted, dtype=torch.bool)
    is_new[1:] = ids_sorted[1:] != ids_sorted[:-1]
    rank = (torch.cumsum(is_new.to(torch.int64), dim=0) - 1).to(torch.int32)

    step = gps * group
    r_alloc = _ranksum_alloc(n_plus1, group)
    rank_of_id = torch.full((n_plus1,), r_alloc - 1, dtype=torch.int32,
                            device=dev)
    rank_of_id[ids_sorted] = rank

    if 0.0 < trunc_frac < 1.0:
        e_cap = max(step, int(tk * trunc_frac) // step * step)
        if e_cap < tk:
            if ov_cap <= 0:
                ov_cap = step
            pos = order[:e_cap].to(torch.int32)
            rank_p = rank[:e_cap]
            w_first = torch.clamp(rank_p[::group], min=0)
            n_real = (ids != n_surfels).sum()
            # shorter than ov_cap when fewer than ov_cap entries follow
            ov_slots = order[e_cap:e_cap + ov_cap].to(torch.int32)
            ov_ids = ids_sorted[e_cap:e_cap + ov_cap].to(torch.int32)
            n_ov = torch.clamp(n_real - e_cap, 0, ov_cap).to(torch.int32)
            return (pos, rank_p, w_first, rank_of_id, ov_slots, ov_ids,
                    n_ov)

    e_pad = (tk + step - 1) // step * step
    pad = e_pad - tk
    pos = torch.cat([order.to(torch.int32),
                     torch.zeros((pad,), dtype=torch.int32, device=dev)])
    rank_p = torch.cat([rank, torch.full((pad,), -1, dtype=torch.int32,
                                         device=dev)])
    w_first = torch.clamp(rank_p[::group], min=0)
    return pos, rank_p, w_first, rank_of_id


def _ranksum_alloc(n_plus1: int, group: int) -> int:
    """Accumulator row count: every write window [w, w+group) with
    w <= max rank <= n_plus1-1 fits, and the last row (the dummy rank
    for absent ids) is never written."""
    return (n_plus1 + group + 7) // 8 * 8


def tile_rays(K: torch.Tensor, height: int, width: int, tile_h: int,
              tile_w: int):
    """Per-tile pixel rays and coordinates: (rays [T, P, 3], pix [T, P, 2])
    with tiles row-major over (ty, tx), pixels row-major within a tile."""
    rays, pix = common.pixel_grid(K, height, width)
    ty, tx = height // tile_h, width // tile_w

    def to_tiles(a):
        c = a.shape[-1]
        a = a.reshape(ty, tile_h, tx, tile_w, c)
        return a.permute(0, 2, 1, 3, 4).reshape(ty * tx, tile_h * tile_w,
                                                c).contiguous()

    return to_tiles(rays), to_tiles(pix)


def untile_px(chans_tiled: torch.Tensor, height: int, width: int,
              tile_h: int, tile_w: int) -> torch.Tensor:
    """[..., T, P, C_ch] (pixel-major kernel output) -> [..., C_ch, H, W]."""
    ty, tx = height // tile_h, width // tile_w
    lead, n_ch = chans_tiled.shape[:-3], chans_tiled.shape[-1]
    a = chans_tiled.reshape(*lead, ty, tx, tile_h, tile_w, n_ch)
    a = torch.movedim(a, -1, len(lead)).transpose(-3, -2)
    return a.reshape(*lead, n_ch, height, width)


def tile_image(img: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """[H, W] or [H, W, C] image -> [T, P(, C)] in kernel tile order
    (tiles row-major over (ty, tx), pixels row-major within a tile)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    height, width, c = img.shape
    ty, tx = height // tile_h, width // tile_w
    a = img.reshape(ty, tile_h, tx, tile_w, c).permute(0, 2, 1, 3, 4)
    a = a.reshape(ty * tx, tile_h * tile_w, c)
    return a[..., 0] if squeeze else a


def untile_image(tiled: torch.Tensor, height: int, width: int, tile_h: int,
                 tile_w: int) -> torch.Tensor:
    """[T, P] per-tile scalar map -> [H, W] (inverse of tile_image)."""
    ty, tx = height // tile_h, width // tile_w
    a = tiled.reshape(ty, tx, tile_h, tile_w)
    return a.permute(0, 2, 1, 3).reshape(height, width)


def pack_features(packed: common.PackedSurfels) -> torch.Tensor:
    """PackedSurfels -> F [N+1, 16] (last row = zero padding target).

    Layout: 0:3 p | 3:6 gu | 6:9 gv | 9:12 n | 12 opacity | 13 depth |
    14 cx | 15 cy.
    """
    F = torch.cat([packed.p, packed.gu, packed.gv, packed.n,
                   packed.opacity[:, None], packed.depth[:, None],
                   packed.center_xy], dim=1)
    return torch.cat([F, F.new_zeros((1, 16))], dim=0)


def build_bucketed_lists(packed: common.PackedSurfels, height: int,
                         width: int, tile_h: int, tile_w: int, k_big: int,
                         k_small: int, q_big: int, cap_ty: int = 9,
                         cap_tx: int = 9):
    """Two-capacity tile buckets (``layout="bucketed"``): the ``q_big``
    highest-count tiles keep ``k_big`` slots, the rest truncate to
    ``k_small`` (the depth-ordered lists drop their farthest surfels, as
    the capacity cap does).  Ties between equal counts keep tile order.

    Returns (lists_b [q_big, k_big], counts_b, idx_b [q_big],
    lists_s [T-q_big, k_small], counts_s, idx_s), int32, with idx_*
    ascending.
    """
    lists, counts, _ = build_tile_lists_sorted(
        packed, height, width, tile_h, tile_w, k_big, cap_ty, cap_tx)
    order = _argsort(-counts)
    idx_b = torch.sort(order[:q_big]).values
    idx_s = torch.sort(order[q_big:]).values
    lists_s = lists[idx_s][:, :k_small].contiguous()
    counts_s = torch.clamp(counts[idx_s], max=k_small)
    return (lists[idx_b], counts[idx_b], idx_b.to(torch.int32),
            lists_s, counts_s, idx_s.to(torch.int32))
