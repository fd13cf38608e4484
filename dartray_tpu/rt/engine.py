"""RT engine: stage orchestration.

Rebuild of the dartray_main state machine (dartray_hub.f90:12-67,
select_rt_type :314-382, rt_prepare :386-469):

  precalc (cells, sources)  -> u_fest   [rad_lim-limited lower bound]
  direct  (cells, sources)  -> u_final (+ scattering source function)
  i_obs_dir                 -> observer intensities of direct light
  scattering iterations     -> u_final += scattered field, scaspe_tot
  i_obs (scattered)         -> observer intensities of scattered light

Stages drive the batched march kernel through the adaptive nside ladder
(rt.rays), chunking sources to bound device memory.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..grid.octree import Grid, build_nav_table
from .. import healpix as hp
from . import march as M
from . import rays as R

# face-neighbour navigation tables, one per grid (built once; the grid is
# immutable during RT).  Keyed by id() with the grid kept referenced so ids
# cannot be recycled.
_NAV_CACHE: dict = {}


def grid_nav(grid: Grid):
    """Device nav table for `grid` (see octree.build_nav_table); None if the
    grid is not graded (the march then falls back to the descend walk)."""
    key = id(grid)
    hit = _NAV_CACHE.get(key)
    if hit is not None and hit[0] is grid:
        return hit[1]
    try:
        nav = jnp.asarray(build_nav_table(grid), dtype=jnp.int32)
    except ValueError:
        nav = None
    _NAV_CACHE[key] = (grid, nav)
    return nav


@dataclasses.dataclass
class Physics:
    """Per-run physical inputs (all device arrays)."""

    dens_ref: jax.Array  # (ncell,) extinction coefficient at lambda_ref [1/pc]
    kext_norm: jax.Array  # (L,) kext(lambda)/kext_ref
    albedo: jax.Array  # (L,)
    gsca: jax.Array  # (L,)
    cs: float  # light speed in grid units [pc/s]
    lambda_um: np.ndarray  # (L,)
    dens_lambda: Optional[jax.Array] = None  # (ncell, L) per-lambda extinction
    #   from lambda-grid files; overrides dens_ref*kext_norm in the march


@dataclasses.dataclass
class SourceSet:
    pos: np.ndarray  # (n,3)
    cell: np.ndarray  # (n,) host/source cell ids
    sid: np.ndarray  # (n,) output row in i_obs (cell id, or ncell+ipsrc)
    lum: np.ndarray  # (n,L)
    point: bool  # True for point sources

    @property
    def n(self):
        return len(self.cell)


def cell_sources(grid: Grid, dens_stars_arr) -> SourceSet:
    """Emitting leaf cells: lumcell = dens_stars * csize^3
    (calc_total_luminosity, rt_routines.f90:605-660)."""
    ds = np.asarray(dens_stars_arr)  # (ncell, L)
    csize = np.asarray(grid.csize)
    leaf = np.asarray(grid.leaf_mask())
    lum = ds * (csize**3)[:, None]
    sel = np.flatnonzero(leaf & (lum.sum(axis=1) > 0))
    return SourceSet(
        pos=np.asarray(grid.ccoord)[sel],
        cell=sel,
        sid=sel,
        lum=lum[sel],
        point=False,
    )


def point_source_set(grid: Grid, pos, lum) -> SourceSet:
    """Point sources with host-cell lookup (prepare_p_src,
    rt_routines.f90:535-576).  The source position is nudged off cell
    borders (fix_ccoord_p_src rt:579-601)."""
    from ..grid.octree import point_to_cell

    pos = np.atleast_2d(np.asarray(pos, dtype=np.float64))
    cell, _ = point_to_cell(grid, pos)
    cell = np.asarray(cell)
    # nudge positions away from the host-cell borders
    cc = np.asarray(grid.ccoord)[cell]
    cs = np.asarray(grid.csize)[cell]
    rel = pos - cc
    onb = np.abs(rel) >= cs[:, None] / 2 * (1 - 1e-9)
    pos = np.where(onb, pos - np.sign(rel) * 1e-6 * cs[:, None], pos)
    return SourceSet(
        pos=pos,
        cell=cell,
        sid=grid.n_cells + np.arange(len(cell)),
        lum=np.atleast_2d(np.asarray(lum)),
        point=True,
    )


def set_en_lim(grid: Grid, accuracy: float, n_point_sources: int = 0) -> float:
    """f_U = accuracy / (0.25 * tot_sources) (set_en_lim,
    rt_routines.f90:3137-3158)."""
    tot_leaf = int(np.sum(np.asarray(grid.leaf_mask())))
    tot_sources = tot_leaf + n_point_sources
    return accuracy / (tot_sources * 0.25)


@dataclasses.dataclass
class StageResult:
    u: jax.Array  # (ncell, L)
    lum_lost: np.ndarray  # (L,)
    stats: dict
    scaspe: Optional[jax.Array] = None  # (ncell, P, L)


def _wall_bounds(cfg, modelsize):
    lo = [-np.inf] * 3
    hi = [np.inf] * 3
    for i, (on, coord) in enumerate(
        [
            (cfg.x_wall_on, cfg.x_wall_coord),
            (cfg.y_wall_on, cfg.y_wall_coord),
            (cfg.z_wall_on, cfg.z_wall_coord),
        ]
    ):
        if on:
            # set_walls (rt_routines.f90:2600-2630): relative -> model units
            lo[i] = coord[0] * modelsize - modelsize / 2.0
            hi[i] = coord[1] * modelsize - modelsize / 2.0
    return tuple(lo), tuple(hi)


# march steps per kernel call before compaction.  The while cond exits as
# soon as every lane finishes, so a long chunk costs nothing when rays die
# early; what it buys is fewer continuation rounds, each of which costs a
# batch rebuild and a host round trip.  Tuned on the previous accelerator;
# not yet tuned on the H100.
STEP_CHUNK = 384


def run_field_stage(
    grid: Grid,
    phys: Physics,
    sources: SourceSet,
    *,
    mode: int,
    u_fest=None,
    u_init=None,
    en_lim: float = 0.0,
    rad_lim: float = 0.1,
    bm_par: float = 10.0,
    bm_par_max: float = 200.0,
    wall_lo=(-np.inf,) * 3,
    wall_hi=(np.inf,) * 3,
    chunk: int = None,  # sources per fresh-launch packet (None = auto)
    fdtype=None,
    scaspe_cfg=None,  # ScaspeConfig; enables per-bucket scaspe deposits
    scaspe_init=None,  # tuple of (ncell, P_k, L_k) per-bucket accumulators
    src_lum_fn=None,  # optional (batch_dict, nside) -> (NR,L) per-ray luminosity override
    step_chunk: int = STEP_CHUNK,
    pool_max: int = None,
    mesh=None,  # jax.sharding.Mesh with a 'rays' axis: shard the march
) -> StageResult:
    """Run one radiation-field stage (precalc or direct) over all sources.

    Rays from every source (and every nside of the adaptive ladder) are
    marched together in global pool rounds (rays.run_rounds); fresh
    launches are pulled lazily in source chunks so memory stays bounded.

    With `mesh`, each round's batch is sharded over the mesh 'rays' axis
    and every device deposits into its own field replica (P1 + P6,
    SURVEY.md §2.2); the replicas are summed once at stage end — the
    reference's reduce_u_*_arr collectives (io_routines.f90:3667-3986).

    ``stats`` carries the stage's rays, intersections ("steps"), march
    loop iterations ("iters"), the luminosity carried off by finished
    rays ("lum_esc", per wavelength) and the stage's host wall time
    ("wall_s").
    """
    import os as _os

    t_stage = time.perf_counter()

    L = phys.kext_norm.shape[0]
    if fdtype is None:
        fdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    # P8 multi-process: each process traces an interleaved slice of the
    # sources on its local mesh; accumulators are summed once at stage end
    # (the reference's rank-strided source loop + reduce_u_*_arr,
    # io_routines.f90:3667-3986).  Stage decisions everywhere use the
    # reduced results, so all processes stay in lockstep.
    n_proc = jax.process_count()
    if n_proc > 1:
        from ..parallel import distributed as DIST

        sources = DIST.split_source_set(sources)
    if pool_max is None:
        # the scattering deposit path carries (NR, P, L) HG weight buffers;
        # cap the batch so ffn stays under ~200 MB (P_tot ~ sum of bucket
        # npix_tot * L_k; 753 for the TRUST stellar range)
        pool_max = R.POOL_MAX
        if scaspe_cfg is not None:
            ptot = sum(
                b.npix_tot * len(b.lam_idx) for b in scaspe_cfg.buckets
            )
            cap = max(1 << 14, int((200 << 20) / (4 * max(ptot, 1))))
            pool_max = min(pool_max, 1 << (cap.bit_length() - 1))
    npix0 = 12 * R.NSIDE_MIN * R.NSIDE_MIN
    if chunk is None:
        chunk = max(1, pool_max // npix0)
    u = (
        jnp.zeros((grid.n_cells, L), dtype=fdtype)
        if u_init is None
        else jnp.asarray(u_init, dtype=fdtype)
    )
    # P8: the cross-process reduction must sum only this stage's DELTA —
    # every process starts from the same u_init baseline (scattering
    # iterations pass the accumulated field), which must enter the total
    # exactly once
    u_base_p8 = u if (n_proc > 1 and u_init is not None) else None
    if u_fest is None:
        u_fest = jnp.zeros((grid.n_cells, L), dtype=fdtype)
    scaspe = scaspe_init
    # P8 delta baseline for scaspe too: the 2D two-pass flow hands pass
    # A's deposits to pass B as scaspe_init
    scaspe_base_p8 = (
        tuple(jnp.asarray(s, dtype=fdtype) for s in scaspe)
        if (n_proc > 1 and scaspe is not None) else None
    )
    ndev = 0
    nwave = 1
    sc_g_call = sc_idx_call = sc_mask_call = ()
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        ndev = mesh.shape["rays"]
        if "wave" in mesh.axis_names:
            nwave = mesh.shape["wave"]
        has_wave = nwave > 1
        slab_sh = NamedSharding(mesh, _P("rays"))
        repl_sh = NamedSharding(mesh, _P())

        def _slab(x, spec=None):
            x = jnp.asarray(x, dtype=fdtype)
            z = jnp.zeros((ndev,) + x.shape, dtype=fdtype).at[0].set(x)
            return jax.device_put(
                z, slab_sh if spec is None else NamedSharding(mesh, spec)
            )

        u = _slab(u)
        u_fest = jax.device_put(jnp.asarray(u_fest, dtype=fdtype), repl_sh)
        if scaspe is not None and scaspe_cfg is not None:
            # P3 wavelength sharding (prepare_scaspe_splitting,
            # rt_routines.f90:2855-2965): pad each bucket's lambda axis to
            # a multiple of the 'wave' size and shard it across that axis;
            # padded columns carry mask 0 so they deposit nothing
            gsca_np = np.asarray(phys.gsca)
            padded, g_l, idx_l, mask_l = [], [], [], []
            for b, s in zip(scaspe_cfg.buckets, scaspe):
                Lk = len(b.lam_idx)
                Lp = -(-Lk // nwave) * nwave
                pad = Lp - Lk
                s = jnp.asarray(s, dtype=fdtype)
                if s.shape[-1] == Lk and pad:
                    s = jnp.pad(s, ((0, 0), (0, 0), (0, pad)))
                padded.append(s)
                g_l.append(jnp.asarray(
                    np.pad(gsca_np[b.lam_idx], (0, pad)), dtype=fdtype))
                idx_l.append(jnp.asarray(
                    np.pad(b.lam_idx, (0, pad)), dtype=jnp.int32))
                mask_l.append(jnp.asarray(
                    np.pad(np.ones(Lk), (0, pad)), dtype=fdtype))
            sc_spec = (
                _P("rays", None, None, "wave") if has_wave else _P("rays")
            )
            lam_sh = NamedSharding(
                mesh, _P("wave") if has_wave else _P())
            scaspe = tuple(_slab(s, sc_spec) for s in padded)
            sc_g_call = tuple(jax.device_put(g, lam_sh) for g in g_l)
            sc_idx_call = tuple(jax.device_put(i, lam_sh) for i in idx_l)
            sc_mask_call = tuple(jax.device_put(m, lam_sh) for m in mask_l)
        elif scaspe is not None:
            scaspe = tuple(_slab(s) for s in scaspe)
    lum_lost = np.zeros(L)
    stats: dict = {}
    dens_ref = jnp.asarray(grid.dens_ref, dtype=fdtype)
    kext_norm = jnp.asarray(phys.kext_norm, dtype=fdtype)
    albedo = jnp.asarray(phys.albedo, dtype=fdtype)
    rad_lim_dist = rad_lim * grid.modelsize if mode == M.MODE_PRECALC else np.inf
    if scaspe_cfg is not None:
        step_chunk = min(step_chunk, 96)
    # utilization knob: the lock-step loop runs to the longest-lived ray
    # in the batch while the average ray dies in a few steps, so shorter
    # chunks + host re-batching trade wasted full-width iterations for
    # extra rounds.  Sweep via DARTRAY_STEP_CHUNK; 0 keeps the defaults.
    env_chunk = int(_os.environ.get("DARTRAY_STEP_CHUNK", "0"))
    if env_chunk > 0:
        step_chunk = env_chunk
    # two-level march loop (march.flush_every): A/B knob, DEFAULT OFF.
    # It exists in case a backend copies while-carried scatter targets on
    # every iteration; an exact equivalence suite
    # (tests/test_march_flush.py) keeps it cheap to re-measure.  Not
    # measured on the H100.
    flush_k = int(_os.environ.get("DARTRAY_FLUSH_K", "0"))
    kw = dict(
        mode=mode,
        point_source=sources.point,
        en_lim=en_lim,
        rad_lim_dist=rad_lim_dist,
        bm_par=float(bm_par),
        bm_par_max=float(bm_par_max),
        cs=phys.cs,
        wall_lo=wall_lo,
        wall_hi=wall_hi,
        max_steps=step_chunk,
        flush_every=flush_k,
        nav=grid_nav(grid),
        dens_lambda=(
            jnp.asarray(phys.dens_lambda, dtype=fdtype)
            if getattr(phys, "dens_lambda", None) is not None else None
        ),
    )
    if scaspe_cfg is not None:
        kw.update(
            collect_en_sca=True,
            scaspe_dirs=tuple(
                jnp.asarray(b.dirs, dtype=fdtype) for b in scaspe_cfg.buckets
            ),
            scaspe_g=tuple(
                jnp.asarray(np.asarray(phys.gsca)[b.lam_idx], dtype=fdtype)
                for b in scaspe_cfg.buckets
            ),
            scaspe_npix_hp=tuple(b.npix_hp for b in scaspe_cfg.buckets),
            scaspe_lam_idx=scaspe_cfg.lam_idx_tuple(),
        )

    _sharded_cache = {}

    def march_fn(batch, beam_i, can_merge, _d=None, small=False):
        nonlocal u, scaspe
        # a scaspe deposit iteration scatters the full (NR, P*L) rows
        # whatever the number of active lanes, so scaspe stages keep chunks
        # short; scaspe-less iterations are cheap, so long chunks save
        # continuation rounds there.  Tuned on the previous accelerator;
        # not yet tuned on the H100.
        mult = 8 if scaspe_cfg is None else 2
        kw_r = kw if not small else dict(kw, max_steps=mult * kw["max_steps"])
        if mesh is not None:
            from ..parallel import mesh as PM

            key = kw_r["max_steps"]
            runf = _sharded_cache.get(key)
            if runf is None:
                kw_s = dict(kw_r)  # device arrays (nav, dens_lambda) become
                #                    replicated closure constants
                runf = PM.make_stage_march(
                    mesh, grid,
                    len(scaspe_cfg.buckets) if scaspe_cfg is not None else 0,
                    **kw_s,
                )
                _sharded_cache[key] = runf
            if scaspe_cfg is not None:
                u, res, scaspe = runf(
                    dens_ref, kext_norm, albedo, u_fest, u, batch,
                    beam_i, can_merge, scaspe,
                    sc_g_call, sc_idx_call, sc_mask_call,
                )
            else:
                u, res = runf(
                    dens_ref, kext_norm, albedo, u_fest, u, batch,
                    beam_i, can_merge,
                )
            return res
        if scaspe_cfg is not None:
            u_new, res, scaspe_new = M.march(
                grid, dens_ref, kext_norm, albedo, u_fest, u, batch,
                beam_i=beam_i, allow_block=can_merge,
                scaspe_accum=scaspe, **kw_r,
            )
            scaspe = scaspe_new
        else:
            u_new, res = M.march(
                grid, dens_ref, kext_norm, albedo, u_fest, u, batch,
                beam_i=beam_i, allow_block=can_merge, **kw_r,
            )
        u = u_new
        return res

    def launches():
        for c0 in range(0, sources.n, chunk):
            hi = min(c0 + chunk, sources.n)
            yield R.fresh_launch(
                sources.pos[c0:hi], sources.cell[c0:hi],
                np.arange(c0, hi), sources.lum[c0:hi],
            )

    R.run_rounds(march_fn, launches(), L, fdtype=fdtype, stats=stats,
                 src_lum_fn=src_lum_fn, pool_max=pool_max,
                 host_lum=scaspe_cfg is not None)

    # lum_lost is accumulated on host from the packed round outputs
    lum_lost = lum_lost + np.asarray(stats.pop("lum_lost", 0.0), dtype=float)

    if mesh is not None:
        # the one per-stage collective (P6/P7): sum the device replicas
        from ..parallel import mesh as PM

        u = PM.stage_reduce(u)
        if scaspe is not None:
            scaspe = tuple(PM.stage_reduce(s) for s in scaspe)
            if scaspe_cfg is not None and nwave > 1:
                # drop the P3 lambda-padding columns (zero by mask)
                scaspe = tuple(
                    s[..., : len(b.lam_idx)] if s.shape[-1] != len(b.lam_idx)
                    else s
                    for s, b in zip(scaspe, scaspe_cfg.buckets)
                )

    if n_proc > 1:
        # P8 stage reduction across processes (reduce_u_*_arr): every
        # process starts from the same u_init/scaspe_init baseline, so
        # only this stage's delta is summed and the baseline re-enters
        # exactly once
        if u_base_p8 is not None:
            u = u_base_p8 + DIST.allreduce_sum(u - u_base_p8)
        else:
            u = DIST.allreduce_sum(u)
        if scaspe is not None:
            scaspe = tuple(
                b + DIST.allreduce_sum(s - b)
                for s, b in zip(scaspe, scaspe_base_p8)
            )
        lum_lost = DIST.allreduce_sum(lum_lost)
        # reduce with a 0 default so the collective count matches across
        # processes even when one of them drew no sources this stage
        for k in ("rays", "steps"):
            stats[k] = int(DIST.allreduce_sum(stats.get(k, 0)))
        stats["lum_esc"] = DIST.allreduce_sum(
            np.asarray(stats.get("lum_esc", np.zeros(L)), dtype=float))

    stats["wall_s"] = time.perf_counter() - t_stage
    return StageResult(u=u, lum_lost=lum_lost, stats=stats, scaspe=scaspe)


def trace_iobs_rays(
    grid: Grid,
    phys: Physics,
    sources: SourceSet,
    theta,
    phi,
    *,
    trace_steps: int = 0,
    fdtype=None,
):
    """March one ray per source toward (theta[i], phi[i]) recording the
    (cell, length) trace; returns (traces dict, i_obs from the march).

    The traces feed rt.replay for differentiable observer intensities: ray
    geometry for iobs rays is independent of the medium, so gradients of
    the replayed intensities w.r.t. density/opacity are exact.
    """
    L = phys.kext_norm.shape[0]
    if fdtype is None:
        fdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if trace_steps == 0:
        trace_steps = 4 * grid.n_fine
    ns = sources.n
    d = dict(
        src_pos=sources.pos,
        src_cell=sources.cell,
        src_idx=np.arange(ns),
        ipix=np.zeros(ns, dtype=np.int64),
        theta=np.asarray(theta),
        phi=np.asarray(phi),
        lum=sources.lum,
        prev=np.zeros(ns),
        cc_old=sources.cell,
        isel_old=np.full(ns, -1, dtype=np.int64),
        dplane=np.zeros(ns),
        fresh=np.ones(ns, dtype=bool),
    )
    from . import rays as R

    batch, _, _ = R._to_batch(d, L, pad_to=R._bucket(ns), fdtype=fdtype)
    dens_ref = jnp.asarray(grid.dens_ref, dtype=fdtype)
    zero_u = jnp.zeros((grid.n_cells, L), dtype=fdtype)
    _, res = M.march(
        grid, dens_ref, jnp.asarray(phys.kext_norm, dtype=fdtype),
        jnp.asarray(phys.albedo, dtype=fdtype), zero_u, zero_u, batch,
        mode=M.MODE_IOBS, point_source=sources.point, trace_steps=trace_steps,
        nav=grid_nav(grid),
        dens_lambda=(
            jnp.asarray(phys.dens_lambda, dtype=fdtype)
            if getattr(phys, "dens_lambda", None) is not None else None
        ),
    )
    traces = dict(
        cells=np.asarray(res.trace_cells)[:ns],
        lengths=np.asarray(res.trace_lengths)[:ns],
        count=np.asarray(res.trace_count)[:ns],
        src_cell=sources.cell,
        csize_nc=np.asarray(grid.csize)[sources.cell],
    )
    return traces, np.asarray(res.i_obs)[:ns]


def run_iobs_stage(
    grid: Grid,
    phys: Physics,
    sources: SourceSet,
    *,
    dir_out=None,  # (ndir, 2) theta, phi of external observers
    pos_obs=None,  # (nobs_in, 3) internal observer positions
    i_obs=None,  # (nsid, ndir, L) accumulator
    i_obs_in=None,  # (nsid, nobs_in, L)
    n_sid: int = 0,
    chunk: int = 2048,
    fdtype=None,
    src_lum_fn=None,  # (theta, phi, cell_ids) -> (n, L): scattered-light source
    src_lum_dir_fn=None,  # (dir_index, cell_ids) -> (n, L): external observers
):
    """Observer-intensity stage (rt_loop_iobs, rt_routines.f90:1470-1603).

    One ray per (source, observer); no blocking, pure attenuation.
    """
    L = phys.kext_norm.shape[0]
    if fdtype is None:
        fdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    n_sid = n_sid or (grid.n_cells + (sources.n if sources.point else 0))
    # P8: rank-strided source split; the per-process i_obs deltas are
    # summed at the end (rows are disjoint across processes)
    n_proc = jax.process_count()
    if n_proc > 1:
        from ..parallel import distributed as DIST

        sources = DIST.split_source_set(sources)
    dens_ref = jnp.asarray(grid.dens_ref, dtype=fdtype)
    kext_norm = jnp.asarray(phys.kext_norm, dtype=fdtype)
    albedo = jnp.asarray(phys.albedo, dtype=fdtype)
    zero_u = jnp.zeros((grid.n_cells, L), dtype=fdtype)

    if i_obs is None and dir_out is not None:
        i_obs = np.zeros((n_sid, len(dir_out), L))
    if i_obs_in is None and pos_obs is not None:
        i_obs_in = np.zeros((n_sid, len(pos_obs), L))
    base_obs = i_obs.copy() if (n_proc > 1 and i_obs is not None) else None
    base_in = i_obs_in.copy() if (n_proc > 1 and i_obs_in is not None) else None

    def run_rays(d, mode, vec_mod=None):
        n = len(d["src_cell"])
        batch, _, _ = R._to_batch(d, L, pad_to=R._bucket(n), fdtype=fdtype)
        if vec_mod is not None:
            vm = np.zeros(batch.n)
            vm[:n] = vec_mod
            vm = jnp.asarray(vm, dtype=fdtype)
        else:
            vm = None
        _, res = M.march(
            grid, dens_ref, kext_norm, albedo, zero_u, zero_u, batch,
            mode=mode, point_source=sources.point, vec_mod=vm,
            nav=grid_nav(grid),
            dens_lambda=(
                jnp.asarray(phys.dens_lambda, dtype=fdtype)
                if getattr(phys, "dens_lambda", None) is not None else None
            ),
        )
        return np.asarray(res.i_obs)[:n]

    for c0 in range(0, sources.n, chunk):
        sl = slice(c0, min(c0 + chunk, sources.n))
        pos = sources.pos[sl]
        cells = sources.cell[sl]
        sids = sources.sid[sl]
        lum = sources.lum[sl]
        ns = len(cells)

        if dir_out is not None and len(dir_out) > 0:
            for j, (th, ph) in enumerate(np.asarray(dir_out)):
                if src_lum_dir_fn is not None:
                    lum_j = src_lum_dir_fn(j, cells)
                elif src_lum_fn is not None:
                    lum_j = src_lum_fn(np.full(ns, th), np.full(ns, ph), cells)
                else:
                    lum_j = lum
                d = dict(
                    src_pos=pos,
                    src_cell=cells,
                    src_idx=np.arange(ns),
                    ipix=np.zeros(ns, dtype=np.int64),
                    theta=np.full(ns, th),
                    phi=np.full(ns, ph),
                    lum=lum_j,
                    prev=np.zeros(ns),
                    cc_old=cells,
                    isel_old=np.full(ns, -1, dtype=np.int64),
                    dplane=np.zeros(ns),
                    fresh=np.ones(ns, dtype=bool),
                )
                i_obs[sids, j] += run_rays(d, M.MODE_IOBS)

        if pos_obs is not None and len(pos_obs) > 0:
            for j, ro in enumerate(np.asarray(pos_obs)):
                vec = ro[None, :] - pos  # source -> observer
                vec_mod = np.sqrt(np.sum(vec**2, axis=1))
                # find_theta_phi_obs_in (rt_routines.f90:3164-3217)
                with np.errstate(invalid="ignore", divide="ignore"):
                    theta = np.arccos(np.clip(vec[:, 2] / np.maximum(vec_mod, 1e-300), -1, 1))
                    phi = np.arctan2(vec[:, 1], vec[:, 0]) % (2 * np.pi)
                theta = np.where(vec_mod > 1e-8, theta, 0.0)
                phi = np.where(vec_mod > 1e-8, phi, 0.0)
                lum_j = (
                    src_lum_fn(theta, phi, cells) if src_lum_fn is not None else lum
                )
                d = dict(
                    src_pos=pos,
                    src_cell=cells,
                    src_idx=np.arange(ns),
                    ipix=np.zeros(ns, dtype=np.int64),
                    theta=theta,
                    phi=phi,
                    lum=lum_j,
                    prev=np.zeros(ns),
                    cc_old=cells,
                    isel_old=np.full(ns, -1, dtype=np.int64),
                    dplane=np.zeros(ns),
                    fresh=np.ones(ns, dtype=bool),
                )
                i_obs_in[sids, j] += run_rays(d, M.MODE_IOBS_IN, vec_mod=vec_mod)

    if n_proc > 1:
        if i_obs is not None:
            i_obs = base_obs + DIST.allreduce_sum(i_obs - base_obs)
        if i_obs_in is not None:
            i_obs_in = base_in + DIST.allreduce_sum(i_obs_in - base_in)
    return i_obs, i_obs_in
