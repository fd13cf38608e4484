"""Batched ray-march kernel: the hot loop of the framework.

Rebuild of ray_tracing / calc_psel / deposit
(rt_routines.f90:1618-1857, 2307-2351, 2362-2557).  Instead of one scalar
ray marched to completion per OpenMP task, a fixed-size *batch* of rays is
advanced in lock-step inside a single ``lax.while_loop`` under ``jit``:

* next-wall selection (calc_psel) is a 3-way min over the batch;
* deposits are scatter-adds into the (ncell, L) radiation-field accumulator
  (P9 of SURVEY.md becomes a scatter-add; on the GPU XLA lowers it to
  atomic adds, so the summation order changes from run to run);
* the DART-Ray blocking rules (ray-precision lower bound
  ``u_beam < f_U * U_LL`` and the beam-density window bm_par/bm_par_max,
  deposit rt_routines.f90:2426-2534) are evaluated vectorized; each ray can
  block at most once per call, so blocked-ray records live in per-ray output
  slots with a status code — no dynamic lists;
* octree navigation uses fine integer coordinates (see grid.octree) —
  increment with carry on the crossed axis, per-level re-floor on the other
  axes (the exact arithmetic of rt_routines.f90:1778-1841).

Wavelengths are carried densely: the per-step math is (NR, L)-shaped, so
the reference's iq compressed-index loop (set_iq_list
rt_routines.f90:1860) is unnecessary.

Layout: all 3-vector quantities (positions, directions, fine coordinates)
are carried as *separate per-axis (NR,) arrays* (structure-of-arrays), so
every elementwise op of the hot loop works on dense (NR,) vectors instead
of (NR, 3) rows with a 3-wide minor axis.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid.octree import Grid

# status codes
ST_ACTIVE = 0
ST_GONE = 1  # finished (killed, exited, or reached rad_lim)
ST_HIGH = 2  # blocked: needs 4x angular refinement (ras_go_high)
ST_LOW = 3  # blocked: merge candidate (ras_go_low)

# march modes (static)
MODE_PRECALC = 0  # deposits to u_fest, rad_lim-limited
MODE_DIRECT = 1  # deposits to u_final (+ scattering source), kill test
MODE_IOBS = 2  # external-observer intensity: attenuation only
MODE_IOBS_IN = 3  # internal-observer intensity: stops at the observer

GLEPSILON = 1.0e-7  # direction sign threshold (rt_routines.f90:76)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RayBatch:
    """A batch of rays (mixed nside allowed via per-ray beam_i)."""

    src_pos: jax.Array  # (NR,3) source position
    src_cell: jax.Array  # (NR,) int32 source cell id (nc)
    theta: jax.Array  # (NR,)
    phi: jax.Array  # (NR,)
    ipix: jax.Array  # (NR,) int32 pixel id at the batch nside
    lum: jax.Array  # (NR,L) ray luminosity (= I * 4 pi csize(nc)^2)
    prev: jax.Array  # (NR,) path length already crossed (0 = fresh)
    cc_old: jax.Array  # (NR,) int32 last intersected cell (relaunch anchor)
    isel_old: jax.Array  # (NR,) int32 axis of last crossing (-1 = none)
    fresh: jax.Array  # (NR,) bool: ray starts at its source
    seen_other: jax.Array  # (NR,) bool: ray already left its start cell
    active: jax.Array  # (NR,) bool

    @property
    def n(self):
        return self.src_pos.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MarchResult:
    status: jax.Array  # (NR,) int32 final status
    lum: jax.Array  # (NR,L) luminosity at exit/blocking
    prev: jax.Array  # (NR,) path length at blocking point
    cc: jax.Array  # (NR,) last cell (blocking records)
    isel_old: jax.Array  # (NR,) entry axis at blocking
    dplane: jax.Array  # (NR,) axis-distance to blocking plane (merge key)
    lum_lost: jax.Array  # (L,) luminosity killed by the f_U criterion
    i_obs: jax.Array  # (NR,L) exit intensity (iobs modes)
    n_steps: jax.Array  # () total ray-cell intersections processed
    lum_esc: jax.Array = None  # (L,) luminosity carried off by rays that
    #                            ended (left the grid, or stopped at a wall
    #                            or at rad_lim): the escape term of the
    #                            energy budget
    cc_cur: jax.Array = None  # (NR,) current cell (for ST_ACTIVE continuation)
    isel_cur: jax.Array = None  # (NR,) current entry axis
    seen_other: jax.Array = None  # (NR,) flag_beam state for continuation
    trace_cells: jax.Array = None  # (NR,S) int32 visited cells (if traced)
    trace_lengths: jax.Array = None  # (NR,S) intersection lengths
    trace_count: jax.Array = None  # (NR,) number of trace entries
    # all scalar per-ray outputs stacked into two arrays so the host driver
    # needs exactly TWO device->host transfers per round:
    packed_i: jax.Array = None  # (8, MP) int32: status, blk_cc, blk_isel,
    #                              cc_cur, isel_cur, seen_other, n_steps,
    #                              loop iterations (telemetry)
    packed_f: jax.Array = None  # (4, MP) fdtype: prev, blk_dplane,
    #                              lum_lost and lum_esc (rows 2-3, first L
    #                              entries)
    packed_all: jax.Array = None  # (12, MP) int32: packed_i rows stacked on
    #                              the float32-bitcast packed_f rows, so the
    #                              host needs ONE transfer (f32 sessions only)


def one_minus_exp(tau):
    """1 - e^-tau without cancellation: computed from e^-tau in float32 it
    is off by a few per cent at tau = 1e-6 and zero below ~6e-8."""
    return -jnp.expm1(-tau)


def exp_tau_minus_one(tau):
    """e^-tau + tau - 1, the own-cell mean-intensity and scattering term,
    without cancellation.  The closed form is zero or negative in float32
    below tau ~ 1e-3, so below tau = 0.5 the Taylor series sum_{k=2..12}
    (-tau)^k / k! stands in (truncation < 2e-13 relative); above it the
    closed form loses < 5e-7 relative in float32."""
    t = jnp.minimum(tau, 0.5)
    acc = 1.0 / math.factorial(12)
    for k in range(11, 1, -1):
        acc = acc * (-t) + 1.0 / math.factorial(k)
    return jnp.where(tau < 0.5, t * t * acc, jnp.exp(-tau) + tau - 1.0)


def _dir_components(theta, phi):
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


def _sel3(isel, x, y, z):
    """Component of (x, y, z) selected by axis index isel (0/1/2)."""
    return jnp.where(isel == 0, x, jnp.where(isel == 1, y, z))


def _level_select(clvl, table_np, dtype=None):
    """table[clvl] for a tiny per-level table, as a where-chain.

    A select chain fuses into the surrounding elementwise kernel, where a
    data gather from the 5-entry table would be one more gather inside
    the hot loop.
    """
    table_np = np.asarray(table_np)
    out = jnp.full(clvl.shape, table_np[0].item(),
                   dtype=dtype or jnp.result_type(table_np))
    for l in range(1, len(table_np)):
        out = jnp.where(clvl == l, table_np[l].item(), out)
    return out


@partial(
    jax.jit,
    static_argnames=(
        "mode",
        "point_source",
        "trace_steps",
        "collect_en_sca",
        "scaspe_npix_hp",
        "flush_every",
    ),
)
def march_legacy(
    grid: Grid,
    dens_ref,  # (ncell,) extinction coeff at lambda_ref [1/length]
    kext_norm,  # (L,) kext(lambda)/kext_ref
    albedo,  # (L,) ksca/kext
    u_fest,  # (ncell, L) lower-bound field (direct mode kill test)
    u_accum,  # (ncell, L) accumulator (u_fest or u_final depending on mode)
    rays: RayBatch,
    *,
    mode: int,
    point_source: bool = False,
    beam_i=None,  # () or (NR,) solid angle per ray = 4 pi / (12 nside^2)
    en_lim=0.0,  # f_U
    rad_lim_dist=jnp.inf,  # rad_lim * modelsize (precalc)
    bm_par=10.0,
    bm_par_max=200.0,
    allow_block=True,  # bool or (NR,): False when nside <= 2*nside_min
    cs=1.0,  # light speed in grid units
    wall_lo=(-jnp.inf, -jnp.inf, -jnp.inf),
    wall_hi=(jnp.inf, jnp.inf, jnp.inf),
    vec_mod=None,  # (NR,) source-observer distance (MODE_IOBS_IN)
    max_steps: int = 100000,
    trace_steps: int = 0,  # record (cell, length) per intersection if > 0
    collect_en_sca: bool = False,  # also accumulate scattered energy per step
    scaspe_dirs=None,  # tuple of (P_k, 3) scaspe direction unit vectors
    scaspe_g=None,  # tuple of (L_k,) HG asymmetry per bucket wavelength
    scaspe_npix_hp=None,  # static tuple of ints: HEALPix pixels per bucket
    scaspe_lam_idx=None,  # tuple of (L_k,) int32 wavelength indices per bucket
    scaspe_lam_mask=None,  # tuple of (L_k,) 0/1 weights: zero for padded
    #                        wavelength columns (lambda-sharded scaspe, P3)
    scaspe_accum=None,  # tuple of (ncell, P_k, L_k) accumulators
    nav=None,  # (ncell*6, NAV_W) int32 face-neighbour table (octree.build_nav_table)
    dens_lambda=None,  # (ncell, L): per-wavelength extinction coefficient
    #                    from lambda-grid files (read_lambda_grid,
    #                    io_routines.f90:397-498); overrides dens_ref*kext_norm
    flush_every: int = 0,  # > 0: two-level loop — an inner lax.scan of this
    #                    many steps RECORDS the (cell, deposit) entries and
    #                    the outer while body flushes them with scatter-adds
    #                    once per segment, in case the backend copies a
    #                    while-carried scatter target on every iteration.
    #                    Off by default; not measured on the H100.
):
    """Advance every ray to completion (exit / kill / block).

    Returns (u_accum, MarchResult[, scaspe_accum]).

    The scattering deposit path (collect_en_sca) adds, for every
    intersection and every kp bucket, ``en_sca(ray, lambda in bucket) *
    ffn(ray, pix)`` into ``scaspe_accum[k][cell, pix, lambda]`` — the
    vectorized equivalent of process_scatt_rad (rt_routines.f90:2638-2726).
    The HG weights ffn depend only on the (fixed) ray direction, so they
    are computed on-device once per kernel call from the small
    (scaspe_dirs, scaspe_g) tables (calc_ffn_arr, rt:2186-2281).
    """
    NR = rays.n
    L = kext_norm.shape[0]
    fdtype = rays.lum.dtype
    csize_lv_np = grid.csize_levels()
    csize_lv = jnp.asarray(csize_lv_np, dtype=fdtype)
    n_fine = grid.n_fine
    max_lvl = grid.max_lvl
    b1, b2 = grid.base
    spl_np = np.asarray(grid.fine_per_level())  # static per-level side counts
    half = jnp.asarray(grid.modelsize / 2.0, dtype=fdtype)

    # per-cell data packed into one row table, so coords+density+[u_fest]
    # are fetched with a single row gather per intersection instead of
    # 4-36 separate 1-wide gathers
    fdat_cols = [grid.ccoord.astype(fdtype), dens_ref[:, None].astype(fdtype)]
    pack_ufest = mode == MODE_DIRECT
    if pack_ufest:
        fdat_cols.append(u_fest.astype(fdtype))
    ufest_off = 4
    dlam_off = ufest_off + (L if pack_ufest else 0)
    if dens_lambda is not None:
        fdat_cols.append(dens_lambda.astype(fdtype))
    fdat = jnp.concatenate(fdat_cols, axis=1)  # (ncell, 4[+L][+L])

    st_ = jnp.sin(rays.theta)
    dx = (st_ * jnp.cos(rays.phi)).astype(fdtype)
    dy = (st_ * jnp.sin(rays.phi)).astype(fdtype)
    dz = jnp.cos(rays.theta).astype(fdtype)
    # sign of each direction component; 0 for axis-perpendicular rays
    # (rt_routines.f90:1666-1669)
    def _inc(c):
        return jnp.clip((c / GLEPSILON).astype(jnp.int32), -1, 1)

    incx, incy, incz = _inc(dx), _inc(dy), _inc(dz)

    def _inv(c, i):
        return jnp.where(i != 0, 1.0 / jnp.where(c == 0, 1.0, c), jnp.inf)

    invx, invy, invz = _inv(dx, incx), _inv(dy, incy), _inv(dz, incz)

    if collect_en_sca:
        # Henyey-Greenstein deposition weights per bucket (calc_ffn_arr,
        # rt_routines.f90:2186-2281): constant along a ray, so computed
        # once per call.  Normalized over the npix_hp HEALPix pixels; the
        # appended observer pixels reuse the normalized values
        # (rt:2258-2266); a single-pixel bucket (isotropic lambdas) gets a
        # uniform weight of 1 (rt:2270).
        # stored FLAT (NR, P_k*L_k): the per-iteration deposit rows stay in
        # the same flat layout as the scaspe accumulator, so the in-loop
        # expand is a multiply + tile instead of a (NR, P, L_k) broadcast
        # with a tiny minor axis and a reshape
        ffn = []
        scaspe_np = []
        for kb, (dirs_k, g_k, nhp_k) in enumerate(
            zip(scaspe_dirs, scaspe_g, scaspe_npix_hp)
        ):
            if nhp_k <= 1:
                w = jnp.ones((NR, dirs_k.shape[0], g_k.shape[0]), dtype=fdtype)
            else:
                dk = dirs_k.astype(fdtype)
                ads = (dx[:, None] * dk[None, :, 0] + dy[:, None] * dk[None, :, 1]
                       + dz[:, None] * dk[None, :, 2])  # (NR, P_k)
                g = g_k.astype(fdtype)[None, None, :]  # (1, 1, L_k)
                w = (1.0 - g**2) / nhp_k * (
                    1.0 + g**2 - 2.0 * g * ads[:, :, None]
                ) ** (-1.5)
                tot = jnp.sum(w[:, :nhp_k, :], axis=1, keepdims=True)
                w = w / jnp.maximum(tot, 1e-300)
            if scaspe_lam_mask is not None:
                w = w * scaspe_lam_mask[kb].astype(fdtype)[None, None, :]
            scaspe_np.append(int(dirs_k.shape[0]))
            ffn.append(w.reshape(NR, -1))
        ffn = tuple(ffn)
        scaspe_np = tuple(scaspe_np)

    sx = rays.src_pos[:, 0].astype(fdtype)
    sy = rays.src_pos[:, 1].astype(fdtype)
    sz = rays.src_pos[:, 2].astype(fdtype)
    nc = rays.src_cell
    csize_nc = grid.csize[nc].astype(fdtype)
    lvl_nc = grid.lvl[nc]
    area_i = csize_nc**2
    csize_i = csize_nc
    intensity0 = rays.lum / (4.0 * jnp.pi * csize_nc**2)[:, None]

    if beam_i is None:
        beam_i = jnp.asarray(4.0 * jnp.pi / 12.0, dtype=fdtype)
    # per-ray solid angle: rays at different nside march in one batch
    beam_i = jnp.broadcast_to(jnp.asarray(beam_i, dtype=fdtype), (NR,))
    can_merge = jnp.broadcast_to(jnp.asarray(allow_block, dtype=bool), (NR,))

    # --- starting cell -----------------------------------------------------
    # fresh rays start in their source cell; relaunched rays start at
    # src + prev*d (find_cc_new2, rt_routines.f90:1962-2066)
    prev0 = rays.prev.astype(fdtype)
    px0 = sx + prev0 * dx
    py0 = sy + prev0 * dy
    pz0 = sz + prev0 * dz
    outside = (
        (jnp.abs(px0) > half) | (jnp.abs(py0) > half) | (jnp.abs(pz0) > half)
    )

    def _refloor(px, py, pz):
        """point (model coords + half) -> per-axis fine int coordinates
        (per-level floor, clamping at edges)."""
        fx = jnp.zeros(px.shape, dtype=jnp.int32)
        fy = jnp.zeros(px.shape, dtype=jnp.int32)
        fz = jnp.zeros(px.shape, dtype=jnp.int32)
        for l in range(1, max_lvl + 1):
            b = b1 if l == 1 else b2
            s_l = int(spl_np[l])
            inv_c = 1.0 / csize_lv[l]
            gx = jnp.clip(jnp.floor(px * inv_c).astype(jnp.int32), 0, b - 1)
            gy = jnp.clip(jnp.floor(py * inv_c).astype(jnp.int32), 0, b - 1)
            gz = jnp.clip(jnp.floor(pz * inv_c).astype(jnp.int32), 0, b - 1)
            px = px - gx.astype(fdtype) * csize_lv[l]
            py = py - gy.astype(fdtype) * csize_lv[l]
            pz = pz - gz.astype(fdtype) * csize_lv[l]
            fx = fx + gx * s_l
            fy = fy + gy * s_l
            fz = fz + gz * s_l
        return fx, fy, fz

    fx0, fy0, fz0 = _refloor(px0 + half, py0 + half, pz0 + half)

    # override with the source-cell coordinates for fresh rays (the source
    # center is always strictly inside its cell)
    cc0, clvl0 = _descend(grid, fx0, fy0, fz0)
    cc = jnp.where(rays.fresh, nc, cc0)
    clvl = jnp.where(rays.fresh, lvl_nc, clvl0)

    active0 = rays.active & ~outside
    # status for rays that exited the model before relaunch
    status0 = jnp.where(rays.active & outside, ST_GONE, ST_ACTIVE)
    status0 = jnp.where(~rays.active, ST_GONE, status0)

    wall_lo = tuple(jnp.asarray(w, dtype=fdtype) for w in wall_lo)
    wall_hi = tuple(jnp.asarray(w, dtype=fdtype) for w in wall_hi)

    if vec_mod is None:
        vec_mod = jnp.full((NR,), jnp.inf, dtype=fdtype)

    do_trace = trace_steps > 0
    # two-level loop only where deposits exist; trace/iobs modes have no
    # big in-loop scatter targets so the single-level loop is already fast
    deferred = flush_every > 0 and mode <= MODE_DIRECT and not do_trace

    state = dict(
        cc=cc.astype(jnp.int32),
        clvl=clvl.astype(jnp.int32),
        fx=fx0,
        fy=fy0,
        fz=fz0,
        prev=prev0,
        isel_old=rays.isel_old.astype(jnp.int32),
        intensity=intensity0,
        seen_other=jnp.asarray(rays.seen_other, dtype=bool),
        active=active0,
        status=status0.astype(jnp.int32),
        # blocking records
        blk_prev=jnp.zeros((NR,), dtype=fdtype),
        blk_cc=jnp.zeros((NR,), dtype=jnp.int32),
        blk_isel=jnp.zeros((NR,), dtype=jnp.int32),
        blk_dplane=jnp.zeros((NR,), dtype=fdtype),
        i_obs=jnp.zeros((NR, L), dtype=fdtype),
        lum_lost=jnp.zeros((L,), dtype=fdtype),
        n_steps=jnp.zeros((), dtype=jnp.int64 if jax.config.jax_enable_x64 else jnp.int32),
        it=jnp.zeros((), dtype=jnp.int32),
    )
    if do_trace:
        state["trace_cells"] = jnp.zeros((NR, trace_steps), dtype=jnp.int32)
        state["trace_lengths"] = jnp.zeros((NR, trace_steps), dtype=fdtype)
        state["trace_count"] = jnp.zeros((NR,), dtype=jnp.int32)
    # accumulators: flat (ncell, P_k*L_k) scaspe, so each deposit is a
    # 2-D row scatter-add.  In the deferred (two-level) mode the
    # accumulators live in the OUTER loop state only, so they are scatter
    # targets once per flush_every steps instead of every step.
    scaspe_flat = (
        tuple(s.reshape(s.shape[0], -1) for s in scaspe_accum)
        if collect_en_sca else None
    )
    if not deferred:
        state["u"] = u_accum
        if collect_en_sca:
            state["scaspe"] = scaspe_flat

    start_cell = cc  # cc_new in the reference: blocking exempt while inside

    def cond(s):
        return jnp.any(s["active"]) & (s["it"] < max_steps)

    def body_core(s):
        """One lock-step march step on the small per-ray state.

        Returns (new_state, (cells, du, en_sca)): the deposit record of
        this step — value rows pre-masked to zero where no deposit
        happens, so applying them is a plain scatter-add (immediately in
        the single-level loop, batched per segment in the two-level one).
        """
        cc, clvl = s["cc"], s["clvl"]
        fx, fy, fz = s["fx"], s["fy"], s["fz"]
        act = s["active"]
        ccs = jnp.clip(cc, 0, grid.n_cells - 1)

        # flag_beam reflects the CURRENT cell (updated before deposit,
        # rt_routines.f90:1729)
        seen_other = s["seen_other"] | (act & (cc != nc) & (cc != start_cell))
        flag_beam = ~seen_other

        crow = fdat[ccs]  # (NR, 4[+L]): the one per-cell row gather
        gx_c = crow[:, 0]
        gy_c = crow[:, 1]
        gz_c = crow[:, 2]
        csize_c = _level_select(clvl, csize_lv_np, fdtype)  # (NR,)
        hcs = 0.5 * csize_c

        # ---- calc_psel (rt_routines.f90:2307-2351) ----
        px = jnp.where(incx != 0, (gx_c - sx + incx.astype(fdtype) * hcs) * invx, jnp.inf)
        py = jnp.where(incy != 0, (gy_c - sy + incy.astype(fdtype) * hcs) * invy, jnp.inf)
        pz = jnp.where(incz != 0, (gz_c - sz + incz.astype(fdtype) * hcs) * invz, jnp.inf)
        psel = jnp.minimum(jnp.minimum(px, py), pz)
        isel = jnp.where(px == psel, 0, jnp.where(py == psel, 1, 2)).astype(jnp.int32)

        length = psel - s["prev"]
        length = jnp.where(jnp.abs(length) < 1e-5 * csize_c, 0.0, length)
        length = jnp.maximum(length, 0.0)
        has_len = length > 0

        # ---- deposit physics (rt_routines.f90:2362-2557) ----
        dref = crow[:, 3]  # (NR,)
        # per-wavelength extinction coefficient: lambda-grid rows when
        # provided (scale_dens_arr is then bypassed, rt_routines.f90:5018),
        # else the reference-wavelength density times kext(l)/kext_ref
        if dens_lambda is not None:
            kx = crow[:, dlam_off : dlam_off + L]
        else:
            kx = dref[:, None] * kext_norm[None, :]
        tau = kx * length[:, None]  # (NR,L)
        exp_tau = jnp.exp(-tau)
        om_tau = one_minus_exp(tau)
        I = s["intensity"]

        is_src_cell = cc == nc
        small = tau < 1e-8
        tau_safe = jnp.where(small, 1.0, tau)
        i_av_ext = jnp.where(small | (I == 0), I, I / tau_safe * om_tau)
        # own-cell optical depth: over ray length for a point source, over
        # the full cell size for homogeneous emission (rt_routines.f90:2409-2417).
        # The point-source special case applies only in the precalc/direct
        # stages (rt_type == rtt_precalc_src / rtt_dir_src in the reference).
        ps_own = point_source and mode <= MODE_DIRECT
        if ps_own:
            tau_own = tau
        else:
            tau_own = kx * csize_i[:, None]
        om_own = om_tau if ps_own else one_minus_exp(tau_own)
        emt_own = exp_tau_minus_one(tau_own)
        sm_own = tau_own < 1e-8
        tau_own_safe = jnp.where(sm_own, 1.0, tau_own)
        if ps_own:
            i_av_own = jnp.where(sm_own | (I == 0), I, I / tau_own_safe * om_own)
        else:
            i_av_own = jnp.where(
                sm_own | (I == 0), I, I / tau_own_safe**2 * emt_own
            )
        i_av = jnp.where(is_src_cell[:, None], i_av_own, i_av_ext)

        vol_f = csize_c**3
        area_f = csize_c**2
        beam_f = area_f / jnp.maximum(psel, 1e-300) ** 2

        # blocking conditions; the beam-density window
        # (deposit rt_routines.f90:2426-2534).  go_high has no nside limit;
        # go_low is disabled for nside <= 2*nside_min (can_merge=False)
        too_sparse = (beam_f / bm_par <= beam_i) & ~flag_beam
        in_window = beam_f / bm_par_max < beam_i
        dep_ok = in_window | flag_beam | ~can_merge
        if mode == MODE_PRECALC:
            beyond = has_len & (psel > rad_lim_dist)
            go_high = has_len & ~beyond & too_sparse
            dep = ~beyond & ~(has_len & too_sparse) & (dep_ok | ~has_len)
            go_low = has_len & ~beyond & ~too_sparse & ~dep_ok
            gone = beyond
            kill_mask = jnp.zeros((NR, L), dtype=bool)
        elif mode == MODE_DIRECT:
            # ray-precision criterion: kill lambdas whose future
            # contribution is below f_U * U_LL (rt_routines.f90:2473-2491)
            u_beam = i_av * (csize_c / cs / vol_f * area_i * beam_f)[:, None]
            ull = crow[:, ufest_off : ufest_off + L]
            kill = u_beam < en_lim * ull
            kill_mask = (has_len & too_sparse)[:, None] & kill
            wall_hit = (
                (gx_c < wall_lo[0]) | (gx_c > wall_hi[0])
                | (gy_c < wall_lo[1]) | (gy_c > wall_hi[1])
                | (gz_c < wall_lo[2]) | (gz_c > wall_hi[2])
            )
            I_after_kill = jnp.where(kill_mask, 0.0, I)
            any_left = jnp.any(I_after_kill > 0, axis=-1)
            go_high = has_len & too_sparse & any_left & ~wall_hit
            gone = has_len & too_sparse & ~go_high
            go_low = has_len & ~too_sparse & ~dep_ok
            dep = ~(has_len & too_sparse) & (dep_ok | ~has_len)
            beyond = jnp.zeros((NR,), dtype=bool)
        else:  # iobs modes: attenuation only, never blocked
            go_high = jnp.zeros((NR,), dtype=bool)
            go_low = jnp.zeros((NR,), dtype=bool)
            gone = jnp.zeros((NR,), dtype=bool)
            dep = jnp.ones((NR,), dtype=bool)
            kill_mask = jnp.zeros((NR, L), dtype=bool)

        do_dep = act & dep & has_len & (mode <= MODE_DIRECT)

        # deposit energy density: i_av * length / cs / vol_f * area_i * beam_i
        du = i_av * (length / cs / vol_f * area_i * beam_i)[:, None]
        du = jnp.where(do_dep[:, None], du, 0.0)

        en_sca = None
        if collect_en_sca:
            # scattered energy created in this intersection
            # (rt_routines.f90:2509-2525); Taylor fallback for small tau
            en_ext = jnp.where(small, I * tau, I * om_tau)
            en_own = jnp.where(
                sm_own,
                I * tau_own / 2.0,
                I / tau_own_safe * emt_own,
            )
            en_sca = jnp.where(is_src_cell[:, None], en_own, en_ext)
            en_sca = en_sca * albedo[None, :] * (area_i * beam_i)[:, None]
            en_sca = jnp.where(do_dep[:, None], en_sca, 0.0)

        if do_trace:
            tc = jnp.clip(s["trace_count"], 0, trace_steps - 1)
            rows = jnp.arange(NR)
            rec = act & has_len & (dep | (mode >= MODE_IOBS))
            trace_cells = s["trace_cells"].at[rows, tc].set(
                jnp.where(rec, cc, s["trace_cells"][rows, tc])
            )
            trace_lengths = s["trace_lengths"].at[rows, tc].set(
                jnp.where(rec, length, s["trace_lengths"][rows, tc])
            )
            trace_count = s["trace_count"] + rec.astype(jnp.int32)

        # intensity update (rt_routines.f90:2543-2555); applies on deposit
        # steps and always in the iobs modes
        I_new_ext = I * exp_tau
        I_new_own = jnp.where(sm_own, I, I / tau_own_safe * om_own)
        I_dep = jnp.where(is_src_cell[:, None], I_new_own, I_new_ext)
        attenuate = act & has_len & (dep | (mode >= MODE_IOBS))
        I_next = jnp.where(attenuate[:, None], I_dep, I)
        # killed lambdas zero out + lum_lost bookkeeping
        killed_now = act[:, None] & kill_mask & (I > 0)
        lum_lost = s["lum_lost"] + jnp.sum(
            jnp.where(killed_now, i_av * (beam_i * csize_i**2)[:, None], 0.0), axis=0
        )
        I_next = jnp.where(killed_now, 0.0, I_next)

        # internal-observer stop (rt_routines.f90:1762-1770)
        if mode == MODE_IOBS_IN:
            hit_obs = act & (vec_mod >= s["prev"]) & (vec_mod <= psel)
            corr = jnp.exp(kx * (psel - vec_mod)[:, None])
            i_obs = jnp.where(hit_obs[:, None], I_next * corr, s["i_obs"])
        else:
            hit_obs = jnp.zeros((NR,), dtype=bool)
            i_obs = s["i_obs"]

        # ---- advance to the next cell (rt_routines.f90:1778-1841) ----
        sz_c = _level_select(clvl, spl_np, jnp.int32)  # fine cells per side
        fsel = _sel3(isel, fx, fy, fz)
        inc_sel = _sel3(isel, incx, incy, incz)
        blk = fsel // sz_c
        fnew_sel = jnp.where(inc_sel > 0, (blk + 1) * sz_c, blk * sz_c - 1)

        # other axes: recompute fine coords from the crossing position
        rx, ry, rz = _refloor(
            psel * dx + sx + half, psel * dy + sy + half, psel * dz + sz + half
        )
        # monotonicity guard: the float recompute can land exactly on a cell
        # boundary and round back *behind* a wall the ray already crossed
        # (degenerate diagonal rays through cell corners), which would
        # ping-pong forever.  Never move a coordinate against the ray
        # direction relative to the current cell's entry coordinates.
        def _mono(r, f, i):
            return jnp.where(i > 0, jnp.maximum(r, f),
                             jnp.where(i < 0, jnp.minimum(r, f), r))

        mx = _mono(rx, fx, incx)
        my = _mono(ry, fy, incy)
        mz = _mono(rz, fz, incz)
        fx_n = jnp.where(isel == 0, fnew_sel, mx)
        fy_n = jnp.where(isel == 1, fnew_sel, my)
        fz_n = jnp.where(isel == 2, fnew_sel, mz)

        if nav is not None:
            # one row gather resolves the next cell: face-neighbour node +
            # one conditional descent step (grading guarantees leaves across
            # a face differ by <= 1 level)
            face = isel * 2 + (inc_sel > 0).astype(jnp.int32)
            nrow = nav[jnp.clip(ccs * 6 + face, 0, nav.shape[0] - 1)]
            nbr = nrow[:, 0]
            cbase = nrow[:, 1]
            nlvl = nrow[:, 2]
            out_grid = nbr < 0
            is_leaf = cbase < 0
            splc = _level_select(
                jnp.clip(nlvl + 1, 0, max_lvl), spl_np, jnp.int32
            )  # child-cell span of an interior nbr

            def _dig(f, o):
                return jnp.clip((f - o) // splc, 0, b2 - 1)

            dgx = _dig(fx_n, nrow[:, 3])
            dgy = _dig(fy_n, nrow[:, 4])
            dgz = _dig(fz_n, nrow[:, 5])
            kidx = (dgz * b2 + dgy) * b2 + dgx
            cc_next = jnp.where(is_leaf, nbr, cbase + kidx)
            clvl_next = jnp.where(is_leaf, nlvl, nlvl + 1).astype(jnp.int32)
            # clamp the fine coords into the entered cell so the integer
            # cell addressing stays consistent at degenerate corner
            # crossings (the float geometry above is exact regardless)
            span_n = _level_select(clvl_next, spl_np, jnp.int32)
            ox = jnp.where(is_leaf, nrow[:, 3], nrow[:, 3] + dgx * splc)
            oy = jnp.where(is_leaf, nrow[:, 4], nrow[:, 4] + dgy * splc)
            oz = jnp.where(is_leaf, nrow[:, 5], nrow[:, 5] + dgz * splc)
            fx_n = jnp.clip(fx_n, ox, ox + span_n - 1)
            fy_n = jnp.clip(fy_n, oy, oy + span_n - 1)
            fz_n = jnp.clip(fz_n, oz, oz + span_n - 1)
        else:
            out_grid = (fnew_sel < 0) | (fnew_sel >= n_fine)
            cc_next, clvl_next = _descend(grid, fx_n, fy_n, fz_n)

        # ---- status resolution ----
        blocked = act & (go_high | go_low)
        exited = act & out_grid & ~blocked & ~gone & ~hit_obs

        if mode == MODE_IOBS:
            i_obs = jnp.where(exited[:, None], I_next, i_obs)

        status = s["status"]
        status = jnp.where(act & go_high, ST_HIGH, status)
        status = jnp.where(act & go_low, ST_LOW, status)
        status = jnp.where(act & gone, ST_GONE, status)
        status = jnp.where(exited | hit_obs, ST_GONE, status)

        # blocking records: entry-plane values (prev, isel_old)
        rec_blk = act & (go_high | go_low)
        blk_prev = jnp.where(rec_blk, s["prev"], s["blk_prev"])
        blk_cc = jnp.where(rec_blk, cc, s["blk_cc"])
        blk_isel = jnp.where(rec_blk, s["isel_old"], s["blk_isel"])
        iold = jnp.clip(s["isel_old"], 0, 2)
        dsel = _sel3(iold, dx, dy, dz)
        dplane_now = jnp.where(s["isel_old"] >= 0, s["prev"] * dsel, 0.0)
        blk_dplane = jnp.where(rec_blk, dplane_now, s["blk_dplane"])

        still_active = act & ~blocked & ~gone & ~exited & ~hit_obs

        new_state = dict(
            cc=jnp.where(still_active, cc_next, cc),
            clvl=jnp.where(still_active, clvl_next, clvl),
            fx=jnp.where(still_active, fx_n, fx),
            fy=jnp.where(still_active, fy_n, fy),
            fz=jnp.where(still_active, fz_n, fz),
            prev=jnp.where(still_active, psel, s["prev"]),
            isel_old=jnp.where(still_active, isel, s["isel_old"]),
            intensity=I_next,
            seen_other=seen_other,
            active=still_active,
            status=status,
            blk_prev=blk_prev,
            blk_cc=blk_cc,
            blk_isel=blk_isel,
            blk_dplane=blk_dplane,
            i_obs=i_obs,
            lum_lost=lum_lost,
            n_steps=s["n_steps"] + jnp.sum(act).astype(s["n_steps"].dtype),
            it=s["it"] + 1,
        )
        if do_trace:
            new_state["trace_cells"] = trace_cells
            new_state["trace_lengths"] = trace_lengths
            new_state["trace_count"] = trace_count
        return new_state, (ccs, du, en_sca)

    def _scaspe_rows(en_row):
        """(NR, L) scattered energy -> per-bucket flat (NR, P_k*L_k) rows:
        scaspe_k[cell, pix, lam] += en[ray, lam in bucket] * ffn_k[ray,
        pix, lam] (process_scatt_rad, rt_routines.f90:2638-2726).

        flat[:, p*L_k + lam] = ffn[:, p, lam] * en[:, lam]: the lam-fastest
        tile of the bucket energies matches the flat ffn layout exactly."""
        return tuple(
            ffn_k * jnp.tile(jnp.take(en_row, idx_k, axis=1), (1, p_k))
            for ffn_k, idx_k, p_k in zip(ffn, scaspe_lam_idx, scaspe_np)
        )

    if not deferred:

        def body(s):
            sc = {k: v for k, v in s.items() if k not in ("u", "scaspe")}
            ns, (ccs_r, du_r, en_r) = body_core(sc)
            ns["u"] = s["u"].at[ccs_r].add(du_r)
            if collect_en_sca:
                ns["scaspe"] = tuple(
                    sk.at[ccs_r].add(rows)
                    for sk, rows in zip(s["scaspe"], _scaspe_rows(en_r))
                )
            return ns

        out = jax.lax.while_loop(cond, body, state)
    else:
        K = flush_every

        def inner(s, _):
            ns, (ccs_r, du_r, en_r) = body_core(s)
            rec = (ccs_r, du_r) + ((en_r,) if collect_en_sca else ())
            return ns, rec

        def outer_body(o):
            s, recs = jax.lax.scan(inner, o["s"], None, length=K)
            cells_k, du_k = recs[0], recs[1]
            # one concatenated (K*NR, L) scatter covers the segment
            o2 = dict(s=s, u=o["u"].at[cells_k.reshape(-1)].add(
                du_k.reshape(K * NR, L)
            ))
            if collect_en_sca:
                en_k = recs[2]
                sc = list(o["scaspe"])
                for j in range(K):
                    rows = _scaspe_rows(en_k[j])
                    for kb in range(len(sc)):
                        sc[kb] = sc[kb].at[cells_k[j]].add(rows[kb])
                o2["scaspe"] = tuple(sc)
            return o2

        o0 = dict(s=state, u=u_accum)
        if collect_en_sca:
            o0["scaspe"] = scaspe_flat
        oo = jax.lax.while_loop(lambda o: cond(o["s"]), outer_body, o0)
        out = dict(oo["s"], u=oo["u"])
        if collect_en_sca:
            out["scaspe"] = oo["scaspe"]

    lum_out = out["intensity"] * (4.0 * jnp.pi * csize_nc**2)[:, None]
    # what finished rays still carry leaves the budget here (killed
    # wavelengths were zeroed and booked in lum_lost)
    ended = (out["status"] == ST_GONE)[:, None]
    lum_esc = jnp.sum(
        jnp.where(ended, out["intensity"] * (area_i * beam_i)[:, None], 0.0),
        axis=0,
    )
    # row length covers L too (a wavelength-rich run can have L > NR)
    MP = max(NR, L)

    def _padrow(v, dt):
        return jnp.zeros((MP,), dtype=dt).at[: v.shape[0]].set(v)

    packed_i = jnp.stack([
        _padrow(out["status"], jnp.int32),
        _padrow(out["blk_cc"], jnp.int32),
        _padrow(out["blk_isel"], jnp.int32),
        _padrow(out["cc"], jnp.int32),
        _padrow(out["isel_old"], jnp.int32),
        _padrow(out["seen_other"].astype(jnp.int32), jnp.int32),
        jnp.broadcast_to(out["n_steps"].astype(jnp.int32), (MP,)),
        # loop iterations executed: per-round kernel-cost telemetry
        # (cost = iterations x per-iteration floor, NOT useful steps)
        jnp.broadcast_to(out["it"].astype(jnp.int32), (MP,)),
    ])
    packed_f = jnp.stack([
        _padrow(out["prev"], fdtype), _padrow(out["blk_dplane"], fdtype),
        _padrow(out["lum_lost"], fdtype), _padrow(lum_esc, fdtype),
    ])
    packed_all = (
        jnp.concatenate(
            [packed_i, jax.lax.bitcast_convert_type(packed_f, jnp.int32)]
        )
        if fdtype == jnp.float32
        else None
    )
    res = MarchResult(
        status=out["status"],
        lum=lum_out,
        prev=out["prev"],
        cc=out["blk_cc"],
        isel_old=out["blk_isel"],
        dplane=out["blk_dplane"],
        lum_lost=out["lum_lost"],
        i_obs=out["i_obs"],
        n_steps=out["n_steps"],
        lum_esc=lum_esc,
        cc_cur=out["cc"],
        isel_cur=out["isel_old"],
        seen_other=out["seen_other"],
        trace_cells=out.get("trace_cells"),
        trace_lengths=out.get("trace_lengths"),
        trace_count=out.get("trace_count"),
        packed_i=packed_i,
        packed_f=packed_f,
        packed_all=packed_all,
    )
    if collect_en_sca:
        scaspe_out = tuple(
            s.reshape(s.shape[0], a.shape[1], a.shape[2])
            for s, a in zip(out["scaspe"], scaspe_accum)
        )
        return out["u"], res, scaspe_out
    return out["u"], res


def march(grid, dens_ref, kext_norm, albedo, u_fest, u_accum, rays, **kw):
    """Advance every ray to completion (exit / kill / block).

    The lock-step kernel serves every round-driver call.  The two-level
    flush_every variant sits behind an env knob with an exact equivalence
    suite (tests/test_march_flush.py); it is not measured on the H100.
    """
    return march_legacy(
        grid, dens_ref, kext_norm, albedo, u_fest, u_accum, rays, **kw
    )


def _descend(grid: Grid, fx, fy, fz):
    """per-axis fine coords (N,) -> (leaf cell, level); inline copy of
    grid.octree.fine_to_cell for use inside the march body."""
    b1, b2 = grid.base
    spl = np.asarray(grid.fine_per_level())
    batch = fx.shape
    child_base = jnp.broadcast_to(grid.cchild[0].astype(jnp.int32), batch)
    cell = jnp.zeros(batch, dtype=jnp.int32)
    clvl = jnp.zeros(batch, dtype=jnp.int32)
    done = jnp.zeros(batch, dtype=bool)
    fxc = jnp.clip(fx, 0, grid.n_fine - 1)
    fyc = jnp.clip(fy, 0, grid.n_fine - 1)
    fzc = jnp.clip(fz, 0, grid.n_fine - 1)
    for l in range(1, grid.max_lvl + 1):
        b = b1 if l == 1 else b2
        s_l = int(spl[l])
        if l == 1:
            dgx, dgy, dgz = fxc // s_l, fyc // s_l, fzc // s_l
        else:
            dgx = (fxc // s_l) % b2
            dgy = (fyc // s_l) % b2
            dgz = (fzc // s_l) % b2
        k = (dgz * b + dgy) * b + dgx
        new_cell = child_base + k
        cell = jnp.where(done, cell, new_cell)
        clvl = jnp.where(done, clvl, l)
        cb = grid.cchild[jnp.clip(new_cell, 0, grid.n_cells - 1)]
        done = done | (cb == -1)
        child_base = jnp.where(done, child_base, cb)
    return cell, clvl
