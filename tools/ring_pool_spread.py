#!/usr/bin/env python3
"""How far chip_smoke phase 7's ring update sits from its band-fold
reference, over several start pools, beside the float-order spreads its
limit is taken from.  Needs one GPU:

    python tools/ring_pool_spread.py [n_starts]

Builds the kernels, makes a ~100k-surfel pool at 64x1024 as phase 3
makes its own (chip_smoke.run_slice, here from the seed's first draws,
so not phase 3's exact pool), and takes it and n_starts - 1 copies with xyz
perturbed by 1e-6 relative as start pools.  For each start it runs the
32-iteration updates of phase 7: the single render under the four
reductions (its spread: ranksum against rmw, fused and plan), the band
fold under the same four (its spread, paired by position), and the
"ring" partition at (1,4) over 4 gloo ranks sharing cuda:0 (this script
with ``--rank``; the parent built the kernels, the ranks only load
them).  Prints per start each spread's (max, 99th percentile) per field
and the ring's pool ratio (chip_smoke.ring_pool_gap) against the
single render's spread, the band fold's and both pooled, the last being
phase 7's gate.
"""
import copy
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

WORLD = 4
RANK_TIMEOUT_S = 600


def _fmt(spread: dict) -> dict:
    return {k: (f"{a:.3e}", f"{b:.3e}") for k, (a, b) in spread.items()}


def _max_into(acc: dict, stats: dict) -> None:
    for k, v in stats.items():
        acc[k] = tuple(max(a, b) for a, b in zip(acc.get(k, (0.0, 0.0)), v))


def _cpu(surf):
    from splatloam_tpu_torch.model import surfels as S
    return S.Surfels(S.SurfelParams(*(x.cpu() for x in surf.params)),
                     surf.active.cpu())


def rank_main(rank: int, port: int, tmp: str) -> None:
    """One of WORLD ranks: the ring update of every start pool."""
    from splatloam_tpu_torch.parallel import initialize_distributed, make_mesh
    from splatloam_tpu_torch.parallel import sharded
    from splatloam_tpu_torch.slam.mapper import MapperPrograms
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORLD))
    initialize_distributed(f"tcp://127.0.0.1:{port}", WORLD, rank,
                           device=dev)
    st = torch.load(Path(tmp) / "starts.pt", map_location=dev,
                    weights_only=False)
    mesh = make_mesh(1, WORLD, device=dev)
    cfg = cs.par_config(st["cfg"], "ring", 1, WORLD)
    out = []
    for surf, adam in st["starts"]:
        progs = MapperPrograms(cfg, cs.H, cs.W, surf.capacity)
        opt = sharded.sharded_optimize_ring(mesh, progs.params, progs.hyper,
                                            cfg.mapping, cfg.compute)
        s_sh, a_sh = sharded.shard_model_state(mesh, surf, adam)
        s2, a2, _, _ = opt(s_sh, a_sh, st["kf"], st["idx"])
        full, _ = sharded.gather_model_state(mesh, s2, a2)
        out.append(_cpu(full))
    torch.distributed.barrier()
    if rank == 0:
        torch.save(out, Path(tmp) / "ring.pt")
    torch.distributed.destroy_process_group()


def run_ranks(tmp: str) -> list:
    port = cs.free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(port), tmp],
        env=dict(os.environ, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(WORLD)),
        start_new_session=True) for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    if any(p.returncode for p in procs):
        raise SystemExit(f"rank exit codes {[p.returncode for p in procs]}")
    return torch.load(Path(tmp) / "ring.pt", weights_only=False)


def main(n_starts: int) -> None:
    from splatloam_tpu_torch.model import surfels as S
    from splatloam_tpu_torch.ops.rasterizer import kernels
    from splatloam_tpu_torch.ops.rasterizer.api import prepare_tiles
    from splatloam_tpu_torch.slam.mapper import MapperPrograms
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script needs a GPU")
    kernels.build_all()
    dev = torch.device("cuda")
    _, (cfg, mapper, model, _) = cs.run_slice(
        dev, np.random.default_rng(cs.SEED))
    kf = mapper._stack_keyframes(model.kf_stack["K"].shape[0])
    surf0 = model.surfels
    # phase 7's tile-list capacity: one that no tile of keyframe 1 fills
    probe = MapperPrograms(cs.par_config(cfg, tile_k=cs.PAR_K_MAX), cs.H,
                           cs.W, model.capacity)
    tiles = prepare_tiles(surf0.params.xyz, surf0.scaling, surf0.params.quat,
                          surf0.opacity, kf.T_cw[1], kf.K[1], probe.params,
                          margin_px=cfg.compute.bin_margin_px)
    chunk = cs.PAR_TILE["chunk"]
    cfg = cs.par_config(cfg, tile_k=(int(tiles.counts.max()) // chunk + 1)
                        * chunk)
    idx = torch.ones((MapperPrograms(cfg, cs.H, cs.W, model.capacity)
                      .n_blocks(),), dtype=torch.long, device=dev)

    def programs(scatter):
        cfg_m = copy.deepcopy(cfg)
        cfg_m.compute.scatter = scatter
        return cfg_m, MapperPrograms(cfg_m, cs.H, cs.W, model.capacity)

    starts, refs = [], []
    for i in range(n_starts):
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        noise = torch.randn(surf0.params.xyz.shape, generator=g, device=dev)
        xyz = surf0.params.xyz * (1.0 + (1e-6 if i else 0.0) * noise)
        surf = S.Surfels(surf0.params._replace(xyz=xyz), surf0.active)
        starts.append((surf, model.adam))
        single, fold = {}, {}
        for scatter in ("ranksum", "rmw", "fused", "plan"):
            cfg_m, progs = programs(scatter)
            single[scatter], *_ = progs.optimize(surf, model.adam, kf, idx)
            fold[scatter] = cs.band_fold_update(cfg_m, progs, surf,
                                                model.adam, kf, idx)[0]
        s_spread, f_spread = {}, {}
        for scatter in ("rmw", "fused", "plan"):
            _max_into(s_spread, cs.diff_stats(cs.pool_diffs(
                single[scatter], single["ranksum"])))
            _max_into(f_spread, cs.diff_stats(cs.ring_pool_diffs(
                fold[scatter], fold["ranksum"])[0]))
        refs.append((s_spread, f_spread, _cpu(fold["ranksum"])))
        print(f"start {i}: single spread {_fmt(s_spread)}; band fold "
              f"spread {_fmt(f_spread)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(cfg=cfg, kf=kf, idx=idx, starts=starts),
                   Path(tmp) / "starts.pt")
        rings = run_ranks(tmp)
    for i, (ring, (s_spread, f_spread, fold)) in enumerate(zip(rings, refs)):
        pooled = {}
        _max_into(pooled, s_spread)
        _max_into(pooled, f_spread)
        for name, spread in (("single", s_spread), ("fold", f_spread),
                             ("pooled", pooled)):
            print(f"start {i}: ring against the band fold / {name} limit "
                  f"{cs.ring_pool_gap(ring, fold, spread)}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
